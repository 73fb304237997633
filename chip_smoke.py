#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failure exits
non-zero):

1. print the card's name and power limit (``nvidia-smi``), build the CUDA
   kernels from ``src/repro_torch/csrc`` and, beside them, this script's own
   (:data:`SMOKE_CU`: kernel C's tick floors and kernel A's scalar
   predecessor), and print what ``ptxas -v`` says of every kernel;
2. kernel A (``accumulate``) against its plain PyTorch version, bit for bit,
   in float32, bfloat16 and int32 at a ragged size and at 64 MiB, and its
   gather-fused form (``shift_accumulate``) on the same sizes as 8 rank
   rows, a ring shift and a partial permutation, x aligned and one element
   off;
3. kernel B (``stencil_sweep``) against its plain version, bit for bit, on
   a (8, 4096, 2048) float32 stack and a ragged bfloat16 stack;
4. the stencil path: ``python -m repro_torch.launch.stencil --grid 2x4
   --domain 8192x8192 --steps 32 --comm-mode smi:static``, overlapped and
   not, each equal bit for bit to the single-rank sweep run with the plain
   version on the card; kernel B must launch during the overlapped run;
   then ``torch.profiler`` splits a warm step's device time by kernel;
5. the reduction path: ``allreduce``, ``reduce_scatter`` and ``reduce`` of
   8 x 16 Mi float32 on ``smi:fused`` against ``smi:static``, on ring(1x8)
   and torus(2x4), bit for bit with equal stats; A's gather-fused form must
   launch once per ring step and its plain add on the rooted folds; each
   reduction timed on both wires in turns (static, fused, fused, static),
   by CUDA events and by its device time;
6. per kernel its launches on its path, time per launch (CUDA events,
   after warm-up, at the path's shapes; for A and C their device time under
   ``torch.profiler``, since their wrappers' host work can outlast their
   kernels), the bound (bytes moved over 3.35 TB/s), the plain version's
   time and one PyTorch library call's time (timed here only, never used
   by the port); A beside its scalar predecessor
   (``ms_before``) at (8, 2 Mi) and (8, 16 Mi), its gather-fused form
   beside the unfused ``ppermute`` + ``torch.add``;
7. kernel C (``router_run``), both its paths (``warp``, a rank on a warp's
   lanes, and ``thread``, one thread a rank), against both plain routers (``impl="vector"``
   and ``"scalar"``), bit for bit on (out_pay, out_cnt, overflow, t_done)
   with equal ticks: the reference's four equivalence configurations on
   torus(2x4) and the snake bus, the out_cap overrun, the step-budget flood,
   an undersized transit that must count overflow, and the halo shape (4096
   float32 at 32 per packet: 128 packets, a 133-tick budget), where both
   paths are timed in turns beside the tick floor (the same number of empty
   ticks of the warp path's barrier in a block of its shape);
8. one RouterConfig re-routed from the torus table to the snake-bus table:
   everything delivered, nothing lost, the kernel library neither rebuilt
   nor reloaded;
9. the paper's Tab. 4 injection workload (R in 1, 4, 8, 16, switch bubble,
   two saturated ports): both paths equal to the plain routers; delivered
   packets, drain ticks, ticks per packet, microseconds per run of each path
   in turns;
10. the stencil path over ``smi:packet`` (overlapped and not), equal bit for
    bit to the single-rank sweep, with 12,928 halo steps and 1,572,864 bytes
    per rank; kernels C (every launch on its warp path) and B must launch;
    then ``torch.profiler`` over 4 overlapped steps: device time by kernel
    and the host ops' self time;
11. ``allreduce``, ``reduce_scatter`` and ``reduce`` of 8 x 16 Mi float32
    over ``packet`` (2048 float32 per packet) on ring(1x8), torus(2x4) and
    the snake bus, equal bit for bit to ``static`` with no loss, every
    launch of kernel C on its warp path; then an ``allreduce`` on a 64-rank
    torus(8x8), past the warp path's 32 ranks: kernel C's thread path;
12. kernel E (``flash_attention_kernel``) against its plain version within
    1e-4 (float32, the FMA kernel) and 1.6e-2 (bfloat16, the wgmma kernel)
    on unit normals, each case asserting which path ran: yi-6b's prefill
    shape (32 heads x 4096 x 128, bfloat16, causal, where E, the FMA
    kernel on the same bfloat16 inputs, its plain version and
    ``scaled_dot_product_attention`` are timed), GQA 32/4 at 1000 real
    keys, Sq 256 != Skv 1024, a 2048-token window at head dim 256 and
    non-causal, each in both dtypes, and in bfloat16 head dim 16 (padded
    to 64) and Sq = 4032 (a multiple of 64, not of 128);
13. yi-6b at full width and depth through ``build_prefill`` on 4096 tokens:
    kernel E launched once per layer (32), every launch on the wgmma path,
    hidden states finite and within a row cosine of 0.999 of the same
    prefill with the plain refs; ms per prefill, tokens/s and kernel E's
    share of the profiled device time;
14. ``python -m repro_torch.launch.serve --arch yi-6b --requests 8
    --max-new 16 --slots 4 --capacity 256`` with ``--engine wave`` and
    ``continuous``: every request's tokens equal across the two engines;
    tokens/s and ms per decode step of each;
15. kernel F (``ssd_scan_kernel``) against its plain version within 1e-4
    (float32) and 1.6e-2 (bfloat16) of the largest magnitude, each case
    asserting the path it names (``ssd_path``: bfloat16 at head dim 64,
    state 128, chunk 128 -> ``wgmma``, the rest -> ``fma``), the ``wgmma``
    cases also within a mean row relative error of 1e-3 (the scores'
    precision; also at the prefill shape on a mamba2 layer's dt range,
    [0.01, 3.7) with A = -1): mamba2-2.7b's prefill shape (80 heads x 4096 x 64, state
    128, B and C one row shared by the heads) in bfloat16, where F on its
    wgmma path, the FMA kernel on the same inputs (``ms_before``) and the
    plain version are timed, and in float32 (the FMA kernel and the plain
    version timed); the reference's broadcast layout in float32, chunks of
    64, one chunk, five chunks (S = 640), a ragged S that the entry point
    pads, and a small case against the sequential ``ssd_ref`` (within
    2e-4);
16. mamba2-2.7b at full width and depth through ``build_prefill`` on 4096
    tokens: kernel F launched once per layer (64), every launch on the
    wgmma path, hidden states finite; every layer's update from its own
    input within a row cosine of 0.999 of the plain scan's, and the float32
    prefill (64 launches, all on the FMA kernel) within 0.999 of its plain
    run end to end (the bfloat16 end-to-end cosine is reported beside the
    noise of two plain runs); ms per prefill, tokens/s, kernel F's share of
    the profiled device time and the device's idle share, and a decode
    tick's wall/device split;
17. phase 14's serving run with ``--arch mamba2-2.7b``: wave and continuous
    tokens equal;
18. kernel D (``matmul``, the overlap engine's per-chunk GEMM) against its
    plain version ``matmul_ref`` within 2e-5 (float32) and 2e-2 (bfloat16)
    of the largest magnitude, each case asserting which path ran: the yi-6b
    TP prefill's four ring-step shapes at P = 8 in bfloat16 (Q, MLP-up with
    the ragged N = 1376, MLP-down with the ragged K = 1376, the
    out-projection), a strided batch and a shared weight on the wgmma
    path; the MLP-up shape in float32, ragged 2-D products and an odd K on
    the mma.sync path.  At each ring-step shape D on both paths and
    ``torch.matmul`` (cuBLAS) are timed beside D's bound, and the wgmma
    path's two grids (persistent, one CTA a tile); at MLP-up also the plain
    version;
19. yi-6b at full width and depth, tensor-parallel over P = 8 ranks stacked
    on the card, ``smi:static``, one sequence of 4096 tokens, bfloat16,
    kernel D injected with ``make_ctx(..., matmul_fn=matmul)``: D launched
    1,280 times (5 projections x 8 ring steps x 32 layers) and E 32 times,
    every launch of both on the wgmma path;
    the hidden states within a row cosine of 0.999 of the same TP prefill
    with ``matmul_fn=None`` (``build_prefill``) and of the tp = 1 prefill of
    the same weights; the ledger's per-tag bytes equal to their closed
    form; ms and tokens/s of the three prefills, and the profiled device
    time split by kernel;
20. the same prefill at 4 layers over ``smi:fused``: bit-equal to
    ``smi:static`` (kernel A's gather-fused form folds the reduce-scatters
    as ``ppermute`` + ``torch.add`` would), A launched once per
    reduce-scatter ring step;
21. channel latency (paper Tab. 3, ``repro_torch.launch.channels``): on an
    8-rank bus at 1, 4 and 7 hops over ``smi:static``, ``smi:fused`` and
    ``smi:packet``, ``open_channel(...).transfer`` of 8 float32 at
    ``n_chunks=1`` and a push/pop loop of 64 elements whose first element
    must arrive on the hops-th pop and whose destination must pop 64; µs
    per transfer and per pop; kernel C launched by the packet wire;
22. channel bandwidth (paper Fig. 9): the same bus at 16 KiB, 256 KiB, 4 MiB
    and 64 MiB per rank, 1, 4 and 7 hops, ``n_chunks=16``, over static,
    fused, packet (to 4 MiB) and ``compressed:static`` beside the
    unpipelined ``staged_p2p``, every delivery checked; GB/s;
23. GESUMMV (paper §5.4.1): ``y = 1.5 A x + 2.5 B x`` over two stacked
    ranks meeting through a channel, within 2e-4 of the single rank at N =
    1024 and 2048; both timed at N = 16384 in float32, GB/s beside the
    memory rate (both ranks share one card's memory: no 2x);
24. collective channels at 8 x 16 Mi float32 on ring(1x8) and torus(2x4)
    over ``smi:static`` and ``smi:fused``: the five kinds' ``transfer``
    bit-equal to the direct collectives, kernel A launched by the reduce
    channels' folds and the all-reduce channels' ring steps, the reduce and
    all-reduce channels timed beside the direct calls by device time; an
    all-reduce over ``compressed:static`` whose int8 wire and result equal
    the CPU's bits; a ``ChannelPool`` spec serving 1,000 all-reduces on one
    claim;
25. the card's link model (the reference's ``--validate-sim``,
    ``launch.channels.validate_sim``): the static wire's Tab. 3 and Fig. 9
    transfers on the 8-rank bus recorded by ``TransportStats.record``
    (seconds the median of 15 readings, the shapes of a set in turns), each
    set fitted and gated at 2x; ``unfused_add_latency`` from phase 5,
    ``quant_latency`` from phase 22 and ``switch_cycles`` from phase 9;
    the fitted ``LinkModel`` printed, and the committed default's worst
    drift on these records (a reading);
26. ``autotune`` of ring(1x8), torus(2x4) and the bus(8), timed, its
    tables printed; ``bcast``, ``reduce`` and ``allreduce`` at one rank's 4
    KiB, 256 KiB and 16 MiB with ``plan="auto"`` against ``plan=None``:
    bcast bit for bit, reductions within 1e-6 of the largest magnitude
    (bit for bit where the tuned algorithm is the default's), an int8 plan
    within the codec's bound; timed in turns beside the tuner's predicted
    ratio; then ``launch.stencil --grid 2x4 --domain 8192x8192 --steps 8
    --plan auto`` equal to the single-rank sweep, kernel B launched;
27. phase 19's yi-6b prefill through ``build_prefill``'s default launch
    (bare ``"smi"``, ``plan="auto"``) with D injected: a backend recorded
    for every layer tag, every D and E launch on ``wgmma``, the ledger
    equal to the closed form on raw tags, within a row cosine of 0.999 of
    ``smi:static`` (or int8 tags held alone to the wire's bound), timed in
    turns with ``smi:static``;
30. (run right after 27, on phase 19's params) the ring-attention prefill:
    yi-6b at full width and depth, P = 8, 4096 tokens, ``build_prefill(mesh=
    (1, 8), comm_mode="smi:static", ring_attn=True)`` within a row cosine
    of 0.999 of the default TP prefill; both timed in turns (wall and device
    time); the attention wire's ledger bytes a layer of both layouts;
28. yi-6b at full width served at P = 8 (bfloat16): ``python -m
    repro_torch.launch.serve --arch yi-6b --mesh 1,8 --layers 4`` (the
    launcher runs cut to 4 of 32 layers: :data:`SERVE_LAYERS`) with phase 14's
    requests, wave then continuous, on ``smi:static`` and on the bare
    ``smi`` (the tuned plan): every request's tokens equal across the four
    runs, kernel A launched on the tuned wire and never on the static one;
    the first decode steps' logits within a row cosine of 0.999 of the
    tp = 1 ``lm_decode_step`` on the same tokens (the tuned plans at the
    decode's bytes printed); the first decode steps on a pinned
    ``smi:fused`` runtime bit-equal to an ``smi:static`` one on the same
    params, caches and tokens, A's launches rising on each fused step, and
    every ring step's operands the fused decode handed A (``(8, 2048)``
    bfloat16) run again through A and its plain version, bit-equal; a
    migration over ``serve.migrate`` with two
    ticks in flight leaving the request's tokens unchanged, the pool's
    ports held for the run and released at shutdown; ms per decode step at
    P = 8 beside tp = 1 in turns, the device time by kernel and the idle
    share; a float32 copy at full width cut to 4 layers within 3e-4
    rtol/atol of tp = 1;
29. ``launch.serve --validate-comm`` on yi-6b at full width and depth at
    meshes ``1,8`` and ``2,4`` over ``smi:static`` and ``smi:fused``: every
    ``serve.*`` tag, migration legs included, equal to
    ``predict_decode_step_stats`` byte for byte and step for step;
31. mamba2-2.7b at full width and depth, P = 8 over ``smi:static`` with D
    injected, 4096 tokens, bfloat16, on phase 16's weights and tokens, in
    turns with the tp = 1 prefill: F launched 64 times over the 8 ranks'
    head rows, all on wgmma, D 1,536 times; the ledger equal to its closed
    form; over ``smi:fused`` bit-equal with A launched once a reduce-scatter
    ring step (455); F gated layer by layer (row cosine >= 0.999 against the plain
    scan) and in float32 end to end (against the plain scan and tp = 1);
32. ``launch.serve --arch mamba2-2.7b --mesh 1,8 --layers 8`` (cut to 8
    of 64 layers: :data:`SERVE_LAYERS`): phase 14's requests,
    both engines on ``smi:static`` and the bare ``smi``, tokens equal
    across the four runs; a
    pinned ``smi:fused`` decode bit-equal to ``smi:static`` (A never
    launched on the static wire); ms a decode step beside tp = 1 in turns,
    the idle share, kernel A's launches a step on the tuned wire;
33. qwen3-moe-30b-a3b at full width and depth (61.1 GB of bfloat16) through
    ``build_prefill`` on 4096 tokens: ms, tokens/s, E launched 48 times on
    wgmma, the device time by kernel and the idle share;
34. the same prefill at P = 8 (``smi:static``, D injected) on the same
    weights, the experts shared as views, in turns with phase 33's: D 768
    and E 48 launches, the ledger equal to its closed form, over
    ``smi:fused`` bit-equal with kernel A launched once a reduce-scatter
    ring step; the row cosine and the share of routing choices that agree
    with tp = 1 reported; then a float32 copy cut to 4 layers (256 tokens):
    the chosen experts equal to tp = 1's and the hidden states within 3e-4
    rtol/atol;
35. ``launch.serve --arch qwen3-moe-30b-a3b --layers 4`` (cut to 4 of
    48 layers: :data:`SERVE_LAYERS`) at tp = 1 (both engines) and at ``--mesh 1,8``
    (both engines, on ``smi:static`` and the bare ``smi``): tokens equal across the runs at each tp; the pinned fused
    decode as phase 32's; ms a decode step beside tp = 1, the idle share,
    A's launches a step;
36. ``launch.serve --validate-comm`` over ``smi:static`` for mamba2-2.7b at
    ``1,8`` and ``2,4`` and qwen3-moe-30b-a3b at ``1,8`` and ``2,4``, the
    last on FSDP weights (``fsdp.gather`` a layer): every tag equal to the
    port's prediction;
37. recurrentgemma-9b at full width and depth (38 layers, the last 2
    remainder ``rec`` layers, 19.1 GB of bfloat16) through ``build_prefill``
    on 4096 tokens: ms, tokens/s, E launched 12 times (the attention
    layers), all on wgmma at head dim 256 with the 2048-token window; hidden
    states within a row cosine of 0.999 of the plain attention's; the
    device time by kind, the RG-LRU scan's, gates' and conv's ranges, and
    the idle share;
38. the same prefill at P = 8 (``smi:static``, D injected) on the same
    weights, in turns with phase 37's: D 1,728 and E 12 launches, the ledger
    equal to its closed form, over ``smi:fused`` bit-equal with A launched
    once a reduce-scatter ring step (539); the bfloat16 row cosine against
    tp = 1 reported; then a float32 copy cut to 5 layers (256 tokens)
    within 3e-4 rtol/atol of the plain tp = 1 prefill and of the plain
    attention at P = 8;
39. ``launch.serve --arch recurrentgemma-9b --layers 5`` (a period and
    the 2 remainder layers of 38: :data:`SERVE_LAYERS`) at tp = 1 and
    ``--mesh 1,8``
    (both engines; at P = 8 on ``smi:static`` and the bare ``smi``): tokens
    equal across the runs at each tp; a pinned ``smi:fused`` decode bit-equal to ``smi:static`` over
    4 steps; ms a decode step beside tp = 1 in turns, the idle share, A's
    launches a step;
40. internvl2-1b at full width and depth: 256 ``pixel_embeds`` and 3840
    text tokens (``data.make_inputs``) prefilled at tp = 1 and P = 8 in
    turns (E 24 and 24, D 960, A 343 over ``smi:fused``); a float32 copy at
    4 layers whose patch positions' embeddings are bit-equal at tp = 1 and
    P = 8 and whose hidden states lie within 3e-4; served at ``--mesh 1,8
    --layers 4`` (4 of 24 layers: :data:`SERVE_LAYERS`; both engines, on
    ``smi:static`` and the bare ``smi``, tokens equal
    across the four runs); a pinned ``smi:fused`` decode bit-equal to
    ``smi:static`` over 2 steps; and a float32 copy served at P = 8 and
    tp = 1 with equal tokens;
41. musicgen-medium at full width and depth: 4096 frames x 4 codebooks
    prefilled at tp = 1 and P = 8 in turns (E 48 and 48, D 1,536, A 679
    over ``smi:fused``); a pinned ``smi:fused`` decode bit-equal to
    ``smi:static``; served at tp = 1 and ``--mesh 1,8`` (both engines; at
    P = 8 on ``smi:static`` and the bare ``smi``; ``--layers 4``, cut to
    4 of 48 layers: :data:`SERVE_LAYERS`), a list of 4 tokens a step, equal across
    the runs at each tp; A's launches a step;
42. ``launch.serve --validate-comm`` over ``smi:static`` for
    recurrentgemma-9b and musicgen-medium at ``1,8`` and ``2,4`` and
    internvl2-1b at ``1,8``: every ``serve.*`` tag equal to the prediction;
43. each kernel's autograd Function against its plain version's autograd
    at the training step's shapes: A's two entry points bit for bit
    (float32 and bfloat16, (8, 1024 x 4096), a ring shift and a partial
    permutation); D on yi-6b's training ring steps at P = 8 (1024 rows a
    rank), its backward two more launches of D each; E on (2, 4096, 32,
    128) causal and F on (80, 4096, 64) at state 128; float32 within 1e-4,
    bfloat16 within the forward's tolerance;
44. yi-6b at full width cut to 8 layers, trained at tp = 1 through
    ``build_train`` on 2 x 4096 tokens a step (bfloat16 compute, float32
    AdamW, ``remat="nothing"``, 8 loss chunks): E launched 16 times a step
    (forward and recompute), D never; every leaf's gradient finite and
    non-zero, within a per-leaf cosine of 0.999 of every kernel off; ms a
    step, tokens/s, the device time by part (forward, recompute, E's plain
    backward, the rest of the backward, the optimizer) and the idle share;
45. the same at P = 8 with D on the GEMMs on the same weights and tokens:
    the first step's loss and gradients bit-equal over ``smi:fused`` and
    ``smi:static`` (A on the fused wire only), D 4x a forward's launches,
    E 16; steps timed on both wires in turns; a float32 copy at 4 layers
    and 2 x 128 tokens against tp = 1: loss within 1e-5, every gradient
    and one AdamW step's params within 3e-4 rtol/atol;
46. mamba2-2.7b trained at tp = 1: at 8 layers the gradients against every
    kernel off (float32 gated at a per-leaf cosine of 0.999, bfloat16
    reported); at full depth (64 layers, bfloat16) F launched twice a layer
    a step, every gradient finite and non-zero, two steps timed and
    profiled;
47. ``launch.train`` for yi-6b at phase 44's cut and batch: 2 steps
    through ``build_train`` and ``train_loop`` at tp = 1 and at ``--mesh
    1,8`` over ``smi:fused``, each exiting 0 with finite losses; then
    ``--validate-comm`` at ``1,8`` over ``smi:fused``: every tag equal to
    ``predict_train_step_stats(eager=True)``;
48. yi-6b at phase 44's cut on a (2, 4) mesh with FSDP over the data axis
    and D: the first step's loss and gradients bit-equal over
    ``smi:fused`` and ``smi:static`` (A on the fused wire only), D, E and A
    counted; 2 steps a wire timed in turns; the device time by range
    (forward, FSDP gather, recompute, backward, gradient sync, optimizer),
    the idle share and the peak memory; a float32 4-layer check against
    (1, 4) on the whole batch (loss 1e-5; gradients and one AdamW step
    3e-4, 3e-4 + 2 lr where the two gradients lie within 3e-4 of 0 with
    opposite signs, those counted);
49. mamba2-2.7b at 16 layers on (2, 4) over ``smi:fused``: the ``"grad"``
    ring alone on odd lengths bit-equal over the fused and static wires;
    2 steps with raw gradients (A launched on the ring, each launch re-run
    against its plain version) and 2 with ``compressed_grads`` (the int8
    ring; its losses beside the raw ones); F twice a layer a group; the
    float32 4-layer check against (1, 4), gated as phase 48's;
50. yi-6b at phase 45's cut at P = 8: one step under each of
    ``"nothing"``, ``"dots"`` and ``"dots_nb"``, the gradients bit-equal
    (else named and within cosine 0.999), D's recompute launches 320 under
    ``"nothing"`` and 0 under ``"dots"``; ms, the recompute's device ms and
    the peak memory of each;
51. GPipe over a chain channel: 8 stages, 16 microbatches of (512, 4096)
    bfloat16, a stage a product on D then a GELU: ``pipeline_loss`` and its
    gradients bit-equal to the stages run one after another, ``pp.stage``
    23 hops, D once a tick in the forward; ms forward and backward;
52. ``launch.train --mesh 2,4 --compressed-grads --validate-comm`` over
    ``smi:fused`` for yi-6b (8 layers) and mamba2-2.7b (16 layers), every
    tag (``fsdp.gather`` and ``grad`` with them) equal to the prediction;
    qwen3-moe-30b-a3b cut to 12 layers served at ``2,4`` on the continuous
    runtime with ``fsdp=True`` then ``False``: the same tokens;
53. ``launch.stencil`` at phase 4's cell over ``smi:fused`` with ``--trace
    --metrics``, in turns with the same run untraced (untraced, traced,
    traced, untraced): every result bit-equal to the single-rank sweep and
    the traced steps' to the untraced run's, B launched, the trace parsed
    back to its events with 8 rank lanes and the host's, one netsim lane a
    directed link (24), 32 ``halo.start`` and 32 ``halo.finish``, a
    ``run.step`` slice a step and rank timed by CUDA events, the snapshot's
    ``halo`` steps and bytes equal to phase 4's per rank; the wall a step
    of both modes.  The halo exchange has no fold, so A runs in a traced
    all-reduce channel over ``smi:fused`` of the stencil's state: A 7
    gather-fused launches, the channel's events, bits equal to
    ``smi:static``;
54. phase 53's stencil over ``smi:packet``: C launched on its warp path,
    the ``router.*`` events present, the snapshot's overflow 0 and its
    ``halo`` equal to phase 10's;
55. ``python -m repro_torch.analysis.lint --json`` (the AST, capture and
    corpus passes; the capture programs on the card at the reference's
    smoke sizes): exit 0, no diagnostic, no real step; then yi-6b cut to
    16 layers at P = 8 over ``smi:static``, served by the continuous
    runtime (4 requests, 8 new tokens), a decode step and a migration
    captured on its params (``analysis.programs.capture_serve``), served
    again: no diagnostic, no real step, the same tokens;
56. the dry run (``launch/dryrun.py``: each step built on the meta device
    at full width, depth and shape and counted, nothing run, kernels D, E
    and F as their own ops; its worker processes start after phase 55 and
    run beside phase 58) of yi-6b,
    mamba2-2.7b and qwen3-moe-30b-a3b x ``train_4k``, ``prefill_32k`` and
    ``decode_32k`` at ``16x16``, command-r-plus-104b ``train_4k`` and
    mamba2-2.7b ``long_500k`` at ``2x16x16``, and phase 57's cuts, on
    worker processes: every record ``ok``; per cell a device's GB, FLOPs,
    collective bytes, the roofline's dominant term and fraction
    (``launch/roofline.py``), and the cells past 80 GB a device named;
57. the cuts phases 13 (yi-6b prefill, 4096 positions, tp = 1), 44
    (yi-6b, 8 layers, 2 x 4096 tokens, tp = 1), 45 (the same at P = 8)
    and 46 (mamba2-2.7b, 64 layers) ran, each dry-run at its own mesh and
    shape and held against that phase's readings (not run again): the
    predicted state bytes equal to the ``nbytes`` of the state the phase
    held, exactly; the predicted peak beside ``max_memory_allocated``; the
    model FLOPs over the measured step as a share of 989e12 (the measured
    roofline fraction) beside the roofline's own;
58. ``python -m repro_torch.launch.train --arch yi-6b --layers 4 --mesh
    2,2,2 --seq-len 4096 --batch 4 --steps 2 --comm-mode smi:fused``, the
    same at ``--mesh 4,2``, and ``--validate-comm`` at ``2,2,2``: every tag
    equal to netsim's prediction, each step's loss bit-equal to ``4,2``'s;
    ms a step of each in turns, and A's, D's and E's launches a step; then
    yi-6b in float32 at both meshes on the same rows: the loss bit-equal,
    every stored gradient leaf within 1e-5 of its largest magnitude;
59. the ranks as processes (``repro_torch.core.spmd``): one spawn of 8
    rank processes, each its own CUDA context on the card, the steps
    between them through mailboxes they map from each other by CUDA IPC:
    (a) the 2x4 stencil at 8192x8192 float32, 8 steps, overlapped and not,
    through ``launch.stencil``'s process-mode run, in turns with the
    stacked run on one world: every run bit-equal to the stacked run's
    and to the single-rank sweep, B launched in every process, the
    ``halo`` steps and bytes the stacked run's, wall a step; (b) ``allreduce`` and ``reduce_scatter`` of 8 x 16 Mi float32
    on ring(1x8) and torus(2x4) over ``smi:static`` and ``smi:fused``, each
    process's rows bit-equal to the stacked ``smi:static`` run's with equal
    counters, A launched in the processes on ``smi:fused``, ms a call in
    turns with the stacked runs; (c) ``launch.channels.latency`` over
    static and fused at 1, 4 and 7 hops with phase 21's checks, µs a
    transfer and a pop (a loop of 32 elements) in turns with the stacked
    runs; then ``launch.stencil --ranks process --procs 2`` (4 ranks a
    process, spawned beside the 8) at (a)'s cell, overlapped, bit-equal to
    the single-rank sweep; then the packet wire with the ranks as
    processes (slice 16): (f) kernel C's block-tick form against its plain
    version, a whole run stepped tick by tick at the halo shape, a
    switch-bubble run on the snake-bus table and an undersized transit that
    overflows, on 1-rank and 4-rank blocks, bit-equal on every output of
    every tick, then its device time a launch beside an empty launch of its
    grid; (c) also covers ``packet``; (d) the 2x4 stencil at 8192x8192 over
    ``smi:packet``, 8 steps, both schedules, on the 8 processes and on the
    2 of 4 ranks: every tile bit-equal to the stacked packet run and the
    single-rank sweep, the ``halo`` counters the stacked run's, no
    overflow, C's block-tick form launched in every process (B on the
    overlapped schedule), ms a step and a tick beside the stacked run; (e)
    ``allreduce`` and ``reduce_scatter`` of 64 Ki float32 a rank over
    ``smi:packet`` on ring(1x8), torus(2x4) and snake_bus(2x4), bit-equal to
    ``smi:static`` with overflow 0 and the stacked packet run's counters;
    (g) phase 8's re-route, torus then snake bus, on one config and one
    packet transport, the kernel library neither rebuilt nor reloaded in
    any process.  Each process's start-up and peak device memory printed;
    phase 1 prints the card's compute mode;
60. parity with the reference's launch layer: ``launch.train --smoke
    --mesh 2,4 --comm-mode smi:packet --validate-comm`` exits 0 (the FSDP
    gather's steps equal the prediction) with kernel C routing the wire;
    yi-6b at phase 44's cut on ``2,4``: ``launch.train --validate-comm``
    over ``smi:compressed`` exits 0, then one batch over ``smi:compressed``
    and ``bulk`` beside ``smi:static`` on the same params (the loss within
    1e-2 relative, every leaf's gradient within a cosine of 0.99; A's, D's
    and E's launches a step), a step of each wire timed in turns with its
    peak memory; ``launch.stencil`` at phase 4's cell over
    ``smi:compressed`` (max error under 1e-1, B launched); the five
    examples (``examples/torch_*.py``) at their defaults on the card, the
    quickstart's Chrome trace written to a temporary directory and read
    back, ``torch_train_lm --full-100m`` for 40 steps with its two
    checkpoints and every CE finite (reported, not gated: on uniform random
    tokens the reference's own run of this recipe ends above its start).

Earlier phases that time or check one schedule pass ``plan=None``.

A ``{"kernels": [...]}`` line carries the rows of phases 6, 7, 12, 15 and
18 (A's and C's rows add ``launches_channels``, their launches in phases
21-24; A, B, D and E add ``launches_tuned``, theirs in phases 26-27; A's rows add
``launches_tp_decode_tuned_per_step``, its launches a decode step in phase
28's launcher runs on the tuned wire, and ``launches_tp_decode_fused_step``, in phase 29's one
validated step over ``smi:fused`` at each mesh; phases 31-35's launches are
``launches_ssm_tp_prefill`` on F's wgmma row and D's,
``launches_moe_prefill`` and ``launches_moe_tp_prefill`` on E's and D's,
and A's ``launches_moe_tp_prefill_fused`` and
``launches_{ssm,moe}_tp_decode_tuned_per_step``; phases 37-41's are
``launches_rg_prefill``, ``launches_{vlm,audio}_prefill`` and
``launches_{rg,vlm,audio}_tp_prefill`` on E's and D's rows, and A's
``launches_{rg,vlm,audio}_tp_prefill_fused`` and
``launches_{rg,vlm,audio}_tp_decode_tuned_per_step``; phases 43-46's
are ``launches_train_step`` on E's and F's wgmma rows (tp = 1), and
``launches_train_tp_step`` on E's and D's rows and A's
``launches_train_tp_step_fused`` (P = 8), a training step's forward,
recompute and backward together, and D's ``launches_grad_phase``;
phases 48-51's are ``launches_train_dp_step`` on E's, D's and F's wgmma
rows and A's ``launches_train_dp_step_fused`` (a (2, 4) step, both data
groups), A's ``launches_grad_ring`` (the ``"grad"`` ring of phase 49's
raw steps), D's ``launches_remat_recompute`` by policy and
``launches_pipeline_forward``; phases 53-55's are B's
``launches_traced_stencil`` by wire, C's warp row's
``launches_traced_stencil``, A's gather-fused row's
``launches_traced_allreduce``, and D's and E's
``launches_captured_serve``; phase 58's are ``launches_pod_train_step`` on
E's and D's rows and A's ``launches_pod_train_step_fused``, a step's at
``2,2,2``; phase 59's, counted in each rank process and summed, are B's
``launches_process_stencil`` and ``launches_process_packet_stencil``, A's
``launches_process_allreduce``, and the row of C's block-tick form
(``router_tick_block``, path ``block``), whose ``launches`` are the
8-process packet stencil's (59 d, both schedules), beside
``launches_procs2_stencil``, ``launches_reductions``,
``launches_latency`` and ``launches_reroute``, and whose times are a
launch's at a 1-rank block, ``at_4_rank_blocks`` beside); phase 60's are
``launches_parity_compressed_step`` on A's, D's and E's rows (a (2, 4)
step over ``smi:compressed``, both groups) and
``launches_parity_packet_cell`` on C's rows (the packet wire's
data-axis cell), each
with the path its kernel ran (``simt``, ``vector``, ``warp``,
``thread``, ``fma`` or ``wgmma``); the rows of A, C, E, F's wgmma path and
D add ``ms_before``, the time in this run of the kernel their calls ran
before (for A, its scalar predecessor; for C's warp row, the thread path;
for F, the FMA kernel on the same bfloat16 inputs); C's rows add
``tick_floor_ms`` and ``us_per_tick``.  F has a row a path: ``wgmma``
launched by phase 16's bfloat16 prefill, ``fma`` by its float32 prefill.
Each phase prints its seconds.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository around it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import functools
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: the H100 SXM data sheet's peaks, the roofline's own: device-memory bytes
#: per second, float32 operations per second outside the tensor cores, dense
#: bfloat16 tensor-core operations per second
from repro_torch.launch.roofline import (  # noqa: E402
    BF16_OPS_PER_S,
    F32_OPS_PER_S,
    HBM_BYTES_PER_S,
)

P = 8
REDUCE_ELEMS = 16 * 1024 * 1024  # per rank
STENCIL_ARGS = ["--grid", "2x4", "--domain", "8192x8192", "--steps", "32",
                "--comm-mode", "smi:static"]
PACKET_STENCIL_ARGS = STENCIL_ARGS[:-1] + ["smi:packet"]
#: halo traffic of one packet stencil run (32 steps of the 2x4 grid's four
#: slabs of a 4096x2048 tile): 404 router ticks a step, as
#: repro.netsim.predict_halo_stats gives for the packet wire
PACKET_HALO = (32 * 404, 32 * 49152)
DIMS = (2, 4)
#: a partial permutation of the P ranks: ranks 2 and 5 receive nothing
PARTIAL_PERM = [(0, 3), (1, 0), (3, 1), (4, 7), (6, 4), (7, 6)]
#: the reference's router equivalence configurations (tests/test_router.py)
EQ_CFGS = {
    "r1": dict(n_ports=1, R=1, switch_bubble=False, tick_batch=1),
    "r4_bubble": dict(n_ports=1, R=4, switch_bubble=True, tick_batch=2),
    "ports2_r8": dict(n_ports=2, R=8, switch_bubble=False, tick_batch=4),
    "ports2_bubble_r16": dict(n_ports=2, R=16, switch_bubble=True, tick_batch=3),
}


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


#: kernels this script times beside the port's, never used by the port:
#: the tick floor of kernel C's warp path (its block of 1024 threads, its
#: ticking warps and its one named barrier a tick, with no work), that of its
#: block-tick form (an empty launch of its grid), and kernel A's scalar
#: predecessor (one float32 a thread, 16 blocks of 256 a SM), the kernel the
#: vector one replaced
SMOKE_CU = r"""
#include <cuda_runtime.h>
#include <cstdint>

// the warp path's tick with no work: a block of 1024 threads of which the
// first `ticking` take one named barrier (with its count) a tick
__global__ void tick_floor_kernel(int n, int ticking, int* ran) {
  if (static_cast<int>(threadIdx.x) >= ticking) return;
  int t = 0, count = 1;
  while (t < n && count) {
    ++t;
    const unsigned go = (threadIdx.x & 31) == 0 && t < n;
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t"
                 "bar.red.popc.u32 %0, 1, %1, p;\n\t}"
                 : "=r"(count) : "r"(ticking), "r"(go) : "memory");
  }
  if (threadIdx.x == 0) ran[0] = t;
}

__global__ void accumulate_scalar_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                       float* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = a[i] + b[i];
}

extern "C" int smoke_tick_floor(int n, int ticking, void* ran, void* stream) {
  tick_floor_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(n, ticking,
                                                                       static_cast<int*>(ran));
  return static_cast<int>(cudaGetLastError());
}

// kernel C's block-tick form with no work: a block of 128 threads a rank
__global__ void empty_tick_kernel() {}

extern "C" int smoke_empty_tick(int blocks, void* stream) {
  empty_tick_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smoke_accumulate_scalar(const void* a, const void* b, void* out, int64_t n,
                                     void* stream) {
  int64_t blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  accumulate_scalar_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
"""
_SMOKE_LIB = {}


def _start_smoke_build():
    """Start ``nvcc`` on :data:`SMOKE_CU` into ``build/chip_smoke/<hash>/``;
    returns (process or None when built, library path)."""
    import hashlib

    from repro_torch.kernels import build

    out = ROOT / "build" / "chip_smoke" / hashlib.sha256(SMOKE_CU.encode()).hexdigest()[:16]
    lib = out / "libsmoke.so"
    if lib.exists():
        return None, lib
    out.mkdir(parents=True, exist_ok=True)
    (out / "smoke.cu").write_text(SMOKE_CU)
    proc = subprocess.Popen([build._nvcc(), *build.ARCH, "-O3", "-std=c++17", "-shared",
                             "-Xcompiler", "-fPIC", "-Xptxas=-v", str(out / "smoke.cu"), "-o",
                             str(lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib


def smoke_lib():
    """The loaded library of :data:`SMOKE_CU` (built in phase 1)."""
    return _SMOKE_LIB["lib"]


def smoke_launch(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: profiles :func:`device_ms` takes before it gives up on one that records no
#: device time
PROFILE_TRIES = 3


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``: its kernels' own time
    under ``torch.profiler`` over ``reps`` calls, after warm-up.  Where the
    host takes longer to issue a call than the card to run it (a short
    kernel behind a Python wrapper), CUDA events around back-to-back calls
    time the host; this times the kernels.  A profile now and then holds
    no kernel row at all; such a profile is taken again, up to
    :data:`PROFILE_TRIES` times."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        busy, _, _ = _profile_device_ms(lambda: [fn() for _ in range(reps)])
        if busy > 0:
            return busy / reps
    raise RuntimeError(f"torch.profiler recorded no device time in {PROFILE_TRIES} profiles")


def graph_ms(fn, reps: int = 50) -> float:
    """Mean milliseconds per call of ``fn`` captured once in a CUDA graph and
    replayed: CUDA events around ``reps`` replays, no host work between the
    kernels (a second measure of device time beside :func:`device_ms`)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps=reps)


def _timed_ms(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _in_turns(fns: dict, order) -> tuple[dict, dict]:
    """Each of ``fns`` timed once for each time it appears in ``order``
    (e.g. a, b, b, a); returns (mean ms, the readings) by name."""
    turns = {k: [] for k in fns}
    for who in order:
        turns[who].append(_timed_ms(fns[who])[1])
    return {k: sum(v) / len(v) for k, v in turns.items()}, turns


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the card's peak rate for their type (float32 unless
    named)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts():
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.router import router_run, router_tick_block
    from repro_torch.kernels.ssd import ssd_scan_kernel
    from repro_torch.kernels.stencil import stencil_sweep
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    stencil_sweep.launches = fused_accumulate.launches = router_run.launches = 0
    router_tick_block.launches = 0
    fused_shift_accumulate.launches = router_run.warp_launches = 0
    flash_attention_kernel.launches = ssd_scan_kernel.launches = matmul.launches = 0
    flash_attention_kernel.wgmma_launches = matmul.wgmma_launches = 0
    ssd_scan_kernel.wgmma_launches = 0


def phase_build():
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    # phase 59's rank processes each need a context on the card: an
    # Exclusive_Process card refuses all but one
    log(f"compute mode: {mode.stdout.strip().splitlines()[0]}")
    t0 = time.perf_counter()
    proc, smoke = _start_smoke_build()
    lib = build.build()
    build.library()
    if proc is not None:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on chip_smoke's own kernels:\n{out}")
    import ctypes

    slib = ctypes.CDLL(str(smoke))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    slib.smoke_tick_floor.argtypes = [i32, i32, p, p]
    slib.smoke_accumulate_scalar.argtypes = [p, p, p, ctypes.c_int64, p]
    slib.smoke_empty_tick.argtypes = [i32, p]
    _SMOKE_LIB["lib"] = slib
    log(f"kernels built in {time.perf_counter() - t0:.1f}s -> {lib}")
    # every kernel's registers, stack and spills; each entry's name first
    for line in (lib.parent / "build.log").read_text().splitlines() if \
            (lib.parent / "build.log").exists() else []:
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
            log(f"ptxas: {entry[:110]}")
        elif "registers" in line or "stack frame" in line or "error" in line.lower():
            log(f"ptxas:   {line.strip()}")


def phase_accumulate(dev) -> float:
    import torch

    from repro_torch.transport.fused import (
        accumulate_plain,
        fused_accumulate,
        fused_shift_accumulate,
        shift_accumulate_plain,
        source_index,
    )

    g = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        itemsize = torch.empty((), dtype=dtype).element_size()
        for n in (1_000_003, (64 << 20) // itemsize):
            if dtype == torch.int32:
                a = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev,
                                  dtype=torch.int32)
                b = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev,
                                  dtype=torch.int32)
            else:
                a = (torch.randn(n, generator=g, device=dev) * 100).to(dtype)
                b = (torch.randn(n, generator=g, device=dev) * 100).to(dtype)
            got, want = fused_accumulate(a, b), accumulate_plain(a, b)
            torch.cuda.synchronize()
            if not same_bits(got, want):
                raise AssertionError(f"accumulate {dtype} n={n}: kernel != plain "
                                     f"(max abs err {max_abs_err(got, want)})")
            worst = max(worst, max_abs_err(got, want))
            log(f"accumulate {str(dtype):>14} n={n:>9}: bit-equal to plain")
            # the gather-fused form on the same sizes as P rank rows (an odd
            # row length at the ragged size, so that rows sit at different
            # offsets modulo 16 bytes), a ring shift and a partial permutation
            # whose ranks 2 and 5 receive nothing (a -0.0 addend there), with
            # x from the start of its buffer and one element into it
            m = -(-n // P)
            flat = torch.cat((a, b))[:P * m + 1]
            for offset in (0, 1):
                x = flat[offset:offset + P * m].view(P, m)
                addend = torch.cat((b, a))[:P * m].view(P, m).clone()
                if dtype != torch.int32:
                    addend[2] = -0.0
                for pname, pairs in (("ring+1", [(i, (i + 1) % P) for i in range(P)]),
                                     ("partial", PARTIAL_PERM)):
                    src = source_index(tuple(pairs), P, dev)
                    before = fused_shift_accumulate.launches
                    got = fused_shift_accumulate(x, addend, src)
                    want = shift_accumulate_plain(x, addend, src)
                    torch.cuda.synchronize()
                    if fused_shift_accumulate.launches != before + 1 or not same_bits(got, want):
                        raise AssertionError(f"shift_accumulate {dtype} ({P}, {m}) offset "
                                             f"{offset} {pname}: kernel != plain")
                    worst = max(worst, max_abs_err(got, want))
            log(f"shift_accumulate {str(dtype):>8} ({P}, {m:>7}): bit-equal to plain "
                f"(ring shift and partial permutation, aligned and at an odd offset)")
    return worst


def phase_stencil_kernel(dev) -> float:
    import torch

    from repro_torch.kernels.stencil import stencil_sweep, stencil_sweep_plain

    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for shape, dtype in (((8, 4096, 2048), torch.float32), ((3, 1001, 777), torch.bfloat16),
                         ((4097, 1029), torch.float32)):
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        got, want = stencil_sweep(x), stencil_sweep_plain(x)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"stencil_sweep {dtype}{shape}: kernel != plain "
                                 f"(max abs err {max_abs_err(got, want)})")
        worst = max(worst, max_abs_err(got, want))
        log(f"stencil_sweep {str(dtype):>14} {shape}: bit-equal to plain")
    return worst


def phase_stencil_path() -> tuple[int, dict]:
    import torch

    from repro_torch.kernels.stencil import stencil_sweep
    from repro_torch.launch import stencil as launch_stencil

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        for sched, extra in (("overlapped", []), ("reference", ["--no-overlap"])):
            out = os.path.join(tmp, f"{sched}.json")
            rc = launch_stencil.main([*STENCIL_ARGS, *extra, "--json", out])
            torch.cuda.synchronize()
            res = json.loads(Path(out).read_text())
            if rc != 0 or not res["ok"] or res["max_err"] != 0.0:
                raise AssertionError(f"stencil {sched}: rc={rc} result={res}")
            results[sched] = res
        launches = stencil_sweep.launches
    if launches == 0:
        raise AssertionError("the overlapped stencil path never launched the stencil kernel")
    log(f"stencil path: kernel B launched {launches} times in the overlapped run")
    return launches, results


def phase_stencil_profile(dev, n_steps: int = 8, comm_mode: str = "smi:static",
                          schedules=(True, False)) -> dict:
    """Where a stencil step's time goes: ``torch.profiler`` over ``n_steps``
    warm steps of each schedule at the path's shape over ``comm_mode``;
    device time by kernel per step, the device's idle share of the wall
    time, and the host ops that hold the most host time (self time; over the
    packet wire, the packetising around each router launch)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.apps import DistributedStencil

    app = DistributedStencil.create((2, 4), comm_mode=comm_mode, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    x = app.scatter(torch.randn((8192, 8192), generator=g, device=dev))
    out = {}
    for overlapped in schedules:
        t = app.halo_schedule.resolve_transport()
        app.run(x, 2, overlapped=overlapped, transport=t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            app.run(x, n_steps, overlapped=overlapped, transport=t)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        events = prof.key_averages()
        # device events only: a CPU op's self device time repeats its kernels'
        rows = sorted(((e.key, e.self_device_time_total / 1e3 / n_steps)
                       for e in events
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                      key=lambda kv: -kv[1])
        host = sorted(((e.key, e.self_cpu_time_total / 1e3 / n_steps, e.count / n_steps)
                       for e in events
                       if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0),
                      key=lambda kv: -kv[1])
        busy = sum(ms for _, ms in rows)
        host_ms = sum(ms for _, ms, _ in host)
        sched = f"{comm_mode} {'overlapped' if overlapped else 'reference'}"
        log(f"profile {sched}: wall {wall_ms:.4f} ms/step, device busy {busy:.4f} ms/step "
            f"(idle {max(0.0, 1 - busy / wall_ms):.1%}), host ops' self time {host_ms:.4f} "
            f"ms/step, {n_steps} steps")
        for name, ms in rows[:10]:
            log(f"profile {sched}:   {ms:.4f} ms/step  {name[:90]}")
        for name, ms, calls in host[:10]:
            log(f"profile {sched}: host {ms:.4f} ms/step in {calls:.0f} calls  {name[:70]}")
        out[sched] = dict(wall_ms=wall_ms, device_ms=busy, host_ms=host_ms, device=rows[:10],
                          host=host[:10])
    return out


def phase_reductions(dev) -> tuple[dict, dict]:
    """Phase 5: the fused reductions bit-equal to the static ones, with equal
    stats; each ring step one launch of the gather-fused add, the rooted
    folds on the add kernel; then each reduction timed over ``smi:static``
    and ``smi:fused`` in turns (static, fused, fused, static).  Returns the
    launches of both entry points of A and the times."""
    import torch

    from repro_torch.core import Communicator
    from repro_torch.core.collectives import allreduce, reduce, stream_reduce_scatter
    from repro_torch.transport import get_transport
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((P, REDUCE_ELEMS), generator=g, device=dev)
    x_before = x.clone()
    ops = {"allreduce": lambda v, c, t: allreduce(v, c, plan=None, transport=t),
           "reduce_scatter": lambda v, c, t: stream_reduce_scatter(v, c, transport=t),
           "reduce": lambda v, c, t: reduce(v, c, root=3, plan=None, transport=t)}
    #: launches of the gather-fused add a call makes: one per ring step
    ring_steps = {"allreduce": P - 1, "reduce_scatter": P - 1, "reduce": 0}
    reset_counts()
    times, launches = {}, {"shift": 0, "fold": 0}
    for names, sizes in ((("x",), (8,)), (("x", "y"), (2, 4))):
        comm = Communicator.create(names, sizes, device=dev)
        for name, op in ops.items():
            ts, tf = get_transport("static", device=dev), get_transport("fused", device=dev)
            want = op(x, comm, ts)
            before = (fused_shift_accumulate.launches, fused_accumulate.launches)
            got = op(x, comm, tf)
            torch.cuda.synchronize()
            shifts = fused_shift_accumulate.launches - before[0]
            folds = fused_accumulate.launches - before[1]
            launches["shift"] += shifts
            launches["fold"] += folds
            if not same_bits(got, want) or not torch.isfinite(got).all():
                raise AssertionError(f"{name} on {sizes}: smi:fused != smi:static")
            if (tf.stats.steps, tf.stats.bytes_moved) != (ts.stats.steps, ts.stats.bytes_moved):
                raise AssertionError(f"{name} on {sizes}: stats differ")
            if shifts != ring_steps[name] or (name == "reduce") != (folds > 0):
                raise AssertionError(f"{name} on {sizes}: {shifts} gather-fused launches (not "
                                     f"{ring_steps[name]}) and {folds} plain folds")
            log(f"{name:>14} on {str(sizes):>7}: smi:fused bit-equal to smi:static "
                f"({tf.stats.steps} steps, {tf.stats.bytes_moved} B per rank; A launched "
                f"{shifts} times gather-fused, {folds} as the plain add)")
            del want, got
            ms, dev_ms = {}, {}
            for mode in ("static", "fused", "fused", "static"):
                t = ts if mode == "static" else tf
                ms.setdefault(mode, []).append(time_ms(lambda: op(x, comm, t), reps=10,
                                                       warmup=2))
                dev_ms.setdefault(mode, []).append(device_ms(lambda: op(x, comm, t), reps=5,
                                                             warmup=1))
            key = f"{name}/{'ring(1x8)' if len(sizes) == 1 else 'torus(2x4)'}"
            times[key] = {m: sum(v) / len(v) for m, v in ms.items()} | {
                f"device_{m}": sum(v) / len(v) for m, v in dev_ms.items()} | {"turns_ms": ms}
            tk = times[key]
            log(f"{name:>14} on {str(sizes):>7}: smi:static {tk['static']:.4f} ms, smi:fused "
                f"{tk['fused']:.4f} ms ({tk['fused'] / tk['static'] - 1:+.1%}; turns "
                f"{', '.join(f'{v:.4f}' for v in ms['static'][:1] + ms['fused'] + ms['static'][1:])}"
                f"); device time {tk['device_static']:.4f} and {tk['device_fused']:.4f} ms "
                f"({tk['device_fused'] / tk['device_static'] - 1:+.1%})")
    if not same_bits(x, x_before):
        raise AssertionError("a reduction modified its input")
    if min(launches.values()) == 0:
        raise AssertionError(f"the fused reductions launched kernel A {launches}")
    log(f"reduction path: kernel A launched {launches['shift']} times gather-fused and "
        f"{launches['fold']} times as the plain add (the checked runs; the timed runs come "
        f"after)")
    return launches, times


def phase_kernel_table(dev, launches_a, launches_b, err_a, err_b) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from repro_torch.core.comm import ppermute
    from repro_torch.kernels.build import current_stream
    from repro_torch.kernels.stencil import stencil_sweep, stencil_sweep_plain
    from repro_torch.transport.fused import (
        accumulate_plain,
        fused_accumulate,
        fused_shift_accumulate,
        shift_accumulate_plain,
        source_index,
    )

    torch.backends.cudnn.allow_tf32 = False  # the library stencil stays in float32
    g = torch.Generator(device=dev).manual_seed(4)
    rows = []

    def scalar_add(a, b):
        """Kernel A's scalar predecessor on the same inputs (``ms_before``)."""
        out = torch.empty_like(a)
        smoke_launch(smoke_lib().smoke_accumulate_scalar(a.data_ptr(), b.data_ptr(),
                                                       out.data_ptr(), a.numel(),
                                                       current_stream(a)), "scalar accumulate")
        return out

    # A at the all-reduce's fold shape, one (P, 16Mi/P) block per step, and
    # at the rooted reduce's (P, 16Mi); its scalar predecessor and torch.add
    # on the same inputs, in turns, each by its device time
    per_shape = {}
    for shape in ((P, REDUCE_ELEMS // P), (P, REDUCE_ELEMS)):
        a = torch.randn(shape, generator=g, device=dev)
        b = torch.randn(shape, generator=g, device=dev)
        if not same_bits(scalar_add(a, b), fused_accumulate(a, b)):
            raise AssertionError(f"the scalar accumulate kernel disagrees at {shape}")
        t = {k: [] for k in ("ms", "ms_before", "library_ms")}
        for _ in range(2):
            t["ms"].append(device_ms(lambda: fused_accumulate(a, b)))
            t["ms_before"].append(device_ms(lambda: scalar_add(a, b)))
            t["library_ms"].append(device_ms(lambda: torch.add(a, b)))
        t = {k: sum(v) / len(v) for k, v in t.items()}
        t["bound_ms"] = bound(3 * a.numel() * a.element_size(), a.numel())[0]
        t["plain_ms"] = time_ms(lambda: accumulate_plain(a, b))
        per_shape[shape] = t
        log(f"accumulate at {list(shape)} f32: {t['ms']:.4f} ms (the scalar predecessor "
            f"{t['ms_before']:.4f} ms, torch.add {t['library_ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms: "
            f"{t['bound_ms'] / t['ms']:.1%} of the bytes rate)")
        del a, b
    t = per_shape[(P, REDUCE_ELEMS // P)]
    rows.append(dict(
        name="accumulate", route="cuda", path="vector",
        source="src/repro_torch/csrc/accumulate.cu", replaces="src/repro/transport/fused.py:35",
        launches=launches_a["fold"], max_abs_err=err_a, ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by="bytes", library_ms=t["library_ms"],
        ms_before=t["ms_before"], shape=[P, REDUCE_ELEMS // P], dtype="float32",
        at_8x16mi={k: v for k, v in per_shape[(P, REDUCE_ELEMS)].items()}))

    # A's gather-fused form at one ring step of the all-reduce: (P, 16Mi/P),
    # a +1 ring shift; beside it the unfused composition (ppermute, then add)
    x = torch.randn((P, REDUCE_ELEMS // P), generator=g, device=dev)
    addend = torch.randn((P, REDUCE_ELEMS // P), generator=g, device=dev)
    pairs = [(i, (i + 1) % P) for i in range(P)]
    src = source_index(tuple(pairs), P, dev)
    got = fused_shift_accumulate(x, addend, src)
    if not same_bits(got, torch.add(ppermute(x, pairs), addend)):
        raise AssertionError("shift_accumulate != ppermute + torch.add")
    t = {k: [] for k in ("ms", "unfused_ms")}
    for _ in range(2):
        t["ms"].append(device_ms(lambda: fused_shift_accumulate(x, addend, src)))
        t["unfused_ms"].append(device_ms(lambda: torch.add(ppermute(x, pairs), addend)))
    t = {k: sum(v) / len(v) for k, v in t.items()}
    t_bound, by = bound(3 * x.numel() * x.element_size(), x.numel())
    plain_ms = time_ms(lambda: shift_accumulate_plain(x, addend, src))
    log(f"shift_accumulate at {list(x.shape)} f32, ring +1: {t['ms']:.4f} ms (unfused "
        f"ppermute + torch.add {t['unfused_ms']:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{t_bound:.4f} ms: {t['ms'] / t_bound:.2f}x the bound)")
    rows.append(dict(
        name="shift_accumulate", route="cuda", path="vector",
        source="src/repro_torch/csrc/accumulate.cu", replaces="src/repro/transport/fused.py:35",
        launches=launches_a["shift"], max_abs_err=err_a, ms=t["ms"], plain_ms=plain_ms,
        bound_ms=t_bound, bound_by=by, library_ms=None, unfused_ms=t["unfused_ms"],
        shape=list(x.shape), dtype="float32"))
    del x, addend, got

    # B at the stencil path's shape: the (8, 4096, 2048) tile stack
    x = torch.randn((P, 4096, 2048), generator=g, device=dev)
    w = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25], [0.0, 0.25, 0.0]],
                     device=dev).view(1, 1, 3, 3)
    x4 = x.view(P, 1, 4096, 2048)
    t_bound, by = bound(2 * x.numel() * x.element_size(), 5 * x.numel())
    rows.append(dict(
        name="stencil_sweep", route="cuda", path="simt", source="src/repro_torch/csrc/stencil.cu",
        replaces="src/repro/kernels/stencil/kernel.py:43", launches=launches_b,
        max_abs_err=err_b, ms=time_ms(lambda: stencil_sweep(x)),
        plain_ms=time_ms(lambda: stencil_sweep_plain(x)), bound_ms=t_bound, bound_by=by,
        library_ms=time_ms(lambda: F.conv2d(x4, w, padding=1)), shape=list(x.shape),
        dtype="float32"))
    return rows


# -- the packet router (kernel C) ----------------------------------------------------


def _stage(dev, n_ports, fifo_cap, pkt_elems, msgs):
    """(src, port, dst, value) messages -> staged (pay, dst, len) on ``dev``."""
    import numpy as np
    import torch

    pay = np.zeros((P, n_ports, fifo_cap, pkt_elems), np.float32)
    dst = np.zeros((P, n_ports, fifo_cap), np.int32)
    ln = np.zeros((P, n_ports), np.int32)
    for s, p, d, val in msgs:
        i = ln[s, p]
        pay[s, p, i] = val
        dst[s, p, i] = d
        ln[s, p] += 1
    return [torch.from_numpy(a).to(dev) for a in (pay, dst, ln)]


def _tables(dev):
    import torch

    from repro_torch.core import Topology, make_router_tables, snake_bus

    return {name: torch.from_numpy(make_router_tables(topo, DIMS)).to(dev)
            for name, topo in (("torus", Topology.torus(DIMS)), ("snake_bus", snake_bus(DIMS)))}


def _halo_job(dev):
    """The router run of one E/W halo permute of the packet stencil: a
    4096-float32 column slab per rank, 32 float32 per packet."""
    import torch

    from repro_torch.core import Communicator
    from repro_torch.netsim import halo_pairs
    from repro_torch.transport import get_transport

    comm = Communicator.create(("x", "y"), DIMS, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    vec = torch.randn((P, 4096), generator=g, device=dev)
    tp = get_transport("packet", device=dev, pkt_elems=32)
    return comm, tp.router_job(vec, comm, halo_pairs(DIMS, 0, +1))


def _router_paths(dev, cfg, comm, tbl, pay, dst, ln, n_steps, name):
    """One router job through both paths of kernel C (the default one and
    the other forced), each held bit for bit against the vector and scalar
    routers, and the two paths' tick counts equal.  Returns the default
    path's outputs and the ticks."""
    import torch

    from repro_torch.core import run_router
    from repro_torch.core.router import _fabric
    from repro_torch.kernels.router import router_path, router_run, tick_spec_of

    names = ("out_pay", "out_cnt", "overflow", "t_done")
    _, link_ids, src = _fabric(tuple(cfg.dims), dev)
    spec = tick_spec_of(cfg, comm.size, link_ids)
    default = router_path(comm.size, cfg.n_ports, spec.n_links, cfg.fifo_cap, cfg.transit_cap)
    before = (router_run.launches, router_run.warp_launches)
    got = run_router(cfg, comm, tbl, pay, dst, ln, n_steps, impl="kernel")
    torch.cuda.synchronize()
    if (router_run.launches, router_run.warp_launches) != \
            (before[0] + 1, before[1] + (default == "warp")):
        raise AssertionError(f"router {name}: the {default} path's counter did not move")
    outs = {default: got}
    for path in ("warp", "thread"):
        if path != default:
            outs[path] = router_run(spec, tbl, src, pay, dst, ln, n_steps, path=path)[:4]
    ticks = {path: int(router_run(spec, tbl, src, pay, dst, ln, n_steps, path=path)[4])
             for path in outs}
    for impl in ("vector", "scalar"):
        want = run_router(cfg, comm, tbl, pay, dst, ln, n_steps, impl=impl)
        torch.cuda.synchronize()
        for path, out in outs.items():
            for a, b, nm in zip(out, want, names):
                if not same_bits(a, b):
                    raise AssertionError(f"router {name}: the {path} path != {impl} on {nm}")
    if len(set(ticks.values())) != 1:
        raise AssertionError(f"router {name}: the paths ran different ticks {ticks}")
    return got, ticks[default]


def _tick_floor_ms(dev, ticks: int, threads: int) -> float:
    """Milliseconds of ``ticks`` empty ticks of the warp path's barrier
    pattern (one counting named barrier a tick over its ``threads`` ticking
    threads, in a block of 1024): the least a run of that many ticks can
    take on this card."""
    import torch

    from repro_torch.kernels.build import current_stream

    ran = torch.zeros((1,), dtype=torch.int32, device=dev)

    def launch():
        smoke_launch(smoke_lib().smoke_tick_floor(ticks, threads, ran.data_ptr(),
                                                  current_stream(ran)), "tick floor")

    launch()
    torch.cuda.synchronize()
    if int(ran) != ticks:
        raise AssertionError(f"the tick floor kernel ran {int(ran)} of {ticks} ticks")
    return device_ms(launch, reps=50)


def phase_router_kernel(dev) -> tuple[float, list[dict]]:
    """Kernel C, both paths, against the vector and scalar routers; returns
    the worst error and the halo-shape timing rows of the kernel table."""
    import numpy as np

    from repro_torch.core import Communicator, RouterConfig, run_router

    comm = Communicator.create(("x", "y"), DIMS, device=dev)
    tables = _tables(dev)
    cases = []
    for name, kw in sorted(EQ_CFGS.items()):
        cfg = RouterConfig(dims=DIMS, fifo_cap=6, transit_cap=8, out_cap=16, pkt_elems=4, **kw)
        rng = np.random.RandomState(sum(map(ord, name)) % 1000)
        msgs = [(s, p, rng.randint(0, P), float(rng.randint(1, 99)))
                for s in range(P) for p in range(cfg.n_ports) for _ in range(rng.randint(0, 5))]
        for topo in ("torus", "snake_bus"):
            cases.append((f"{name}/{topo}", cfg, tables[topo], msgs, 64))
    cfg = RouterConfig(dims=DIMS, n_ports=1, fifo_cap=8, transit_cap=16, out_cap=2, pkt_elems=4)
    cases.append(("out_cap_overrun", cfg, tables["torus"],
                  [(s, 0, 0, float(10 + s)) for s in (1, 2, 4, 5)], 64))
    cfg = RouterConfig(dims=DIMS, n_ports=1, fifo_cap=8, transit_cap=8, out_cap=8, pkt_elems=4,
                       tick_batch=4)
    cases.append(("step_budget", cfg, tables["torus"],
                  [(s, 0, (s + 1 + k) % P, float(10 * s + k)) for s in range(P) for k in range(4)],
                  5))
    cfg = RouterConfig(dims=DIMS, n_ports=2, fifo_cap=6, transit_cap=1, out_cap=16, pkt_elems=4,
                       R=4)
    cases.append(("transit_cap_1", cfg, tables["torus"],
                  [(s, p, (s + 2 + 3 * p) % P, float(10 * s + p)) for s in range(P)
                   for p in range(2) for _ in range(3)], 64))
    worst = 0.0
    for name, cfg, tbl, msgs, n_steps in cases:
        staged = _stage(dev, cfg.n_ports, cfg.fifo_cap, cfg.pkt_elems, msgs)
        got, ticks = _router_paths(dev, cfg, comm, tbl, *staged, n_steps, name)
        log(f"router {name:>26}: warp and thread paths bit-equal to vector and scalar "
            f"(delivered {int(got[1].sum())}, overflow {int(got[2].sum())}, {ticks} ticks)")
        if name == "out_cap_overrun" and (int(got[1][0, 0]), int(got[2].sum())) != (2, 2):
            raise AssertionError("out_cap overrun: expected 2 delivered and 2 counted")
        if name == "transit_cap_1" and int(got[2].sum()) == 0:
            raise AssertionError("an undersized transit counted no overflow")

    # the halo shape: also where kernel C is timed, both paths in turns
    from repro_torch.core.router import _fabric
    from repro_torch.kernels.router import router_run, tick_spec_of
    from repro_torch.kernels.router.kernel import warp_lanes

    comm, (cfg, tbl, pay, dst, ln, n_steps) = _halo_job(dev)
    args = (cfg, comm, tbl, pay, dst, ln, n_steps)
    got, ticks = _router_paths(dev, *args[:3], pay, dst, ln, n_steps, "halo shape")
    for impl in ("vector", "scalar"):
        worst = max(worst, max_abs_err(got[0], run_router(*args, impl=impl)[0]))
    links, link_ids, src = _fabric(DIMS, dev)
    spec = tick_spec_of(cfg, P, link_ids)
    packets = int(ln.sum())
    if int(got[1].sum()) != packets or int(got[2].sum()) != 0:
        raise AssertionError("router halo shape: packets lost")
    # device time: the host issues a warp-path call more slowly than the card
    # runs it, so CUDA events around back-to-back calls would time the host;
    # measured two ways, the kernels' time under the profiler and a CUDA
    # graph of one call replayed
    turns, graph_turns = {"warp": [], "thread": []}, {"warp": [], "thread": []}
    for path in ("warp", "thread", "thread", "warp"):
        run = lambda: router_run(spec, tbl, src, pay, dst, ln, n_steps, path=path)  # noqa: E731
        turns[path].append(device_ms(run))
        graph_turns[path].append(graph_ms(run))
    ms = {k: sum(v) / len(v) for k, v in turns.items()}
    wall_ms = time_ms(lambda: router_run(spec, tbl, src, pay, dst, ln, n_steps))
    log("router halo shape, turns (warp, thread, thread, warp) in ms: profiler " + ", ".join(
        f"{p} {v:.4f}" for p, vs in turns.items() for v in vs) + "; graph replay " + ", ".join(
        f"{p} {v:.4f}" for p, vs in graph_turns.items() for v in vs))
    lanes = warp_lanes(cfg.n_ports, len(links))
    ticking = 2 * 32 * -(-P // (32 // lanes))  # the ranks' control and delivery warps
    floor_ms = _tick_floor_ms(dev, ticks, ticking)
    plain_ms = time_ms(lambda: run_router(*args, impl="vector"), reps=3, warmup=1)
    # bytes: each staged packet and header read once, the lengths, route
    # table and exchange table read once, every output written once
    E, itemsize = cfg.pkt_elems, 4
    nbytes = itemsize * (packets * (E + 1) + ln.numel() + tbl.numel() + src.numel() + len(links)
                         + got[0].numel() + got[1].numel() + got[2].numel() + got[3].numel())
    bytes_ms, _ = bound(nbytes, 0)
    log(f"router halo shape: {packets} packets, {ticks} of {n_steps} ticks run; warp path "
        f"{ms['warp']:.4f} ms ({ms['warp'] / ticks * 1e3:.3f} us/tick), thread path "
        f"{ms['thread']:.4f} ms ({ms['thread'] / ticks * 1e3:.3f} us/tick), tick floor "
        f"{floor_ms:.4f} ms ({floor_ms / ticks * 1e3:.3f} us/tick, {ticking} threads), all "
        f"device time; back-to-back calls {wall_ms:.4f} ms a call (CUDA events); plain "
        f"{plain_ms:.4f} ms, bytes {bytes_ms:.6f} ms")
    rows = []
    for path in ("warp", "thread"):
        rows.append(dict(
            name="router_run", route="cuda", path=path, source="src/repro_torch/csrc/router.cu",
            replaces="src/repro/kernels/router/kernel.py:83", launches=0, max_abs_err=worst,
            ms=ms[path], plain_ms=plain_ms, bound_ms=bytes_ms, bound_by="bytes",
            tick_floor_ms=floor_ms, tick_floor_by="tick chain", library_ms=None, ticks=ticks,
            tick_budget=n_steps, events_ms_per_call=wall_ms if path == "warp" else None,
            graph_ms=sum(graph_turns[path]) / len(graph_turns[path]),
            us_per_tick=ms[path] / ticks * 1e3, floor_us_per_tick=floor_ms / ticks * 1e3,
            shape=list(pay.shape), dtype="float32"))
    rows[0]["ms_before"] = ms["thread"]
    return worst, rows


def phase_router_reroute(dev):
    """One RouterConfig, the torus table then the snake-bus table: all
    delivered, nothing lost, no rebuild and no reload of the kernels."""
    from repro_torch.core import Communicator, RouterConfig, run_router
    from repro_torch.kernels import build

    comm = Communicator.create(("x", "y"), DIMS, device=dev)
    cfg = RouterConfig(dims=DIMS)
    msgs = [(0, 0, 5, 9.0), (2, 1, 6, 8.0), (7, 0, 1, 3.0), (4, 1, 3, 2.0), (6, 0, 0, 7.0)]
    staged = _stage(dev, cfg.n_ports, cfg.fifo_cap, cfg.pkt_elems, msgs)
    lib, cache, digest = build.library(), build.library.cache_info(), build._digest()
    for topo, tbl in _tables(dev).items():
        out_pay, out_cnt, ovf, _ = run_router(cfg, comm, tbl, *staged, 64, impl="kernel")
        if int(ovf.sum()) != 0:
            raise AssertionError(f"re-route {topo}: packets lost")
        for _s, p, d, val in msgs:
            if val not in out_pay[d, p, :int(out_cnt[d, p]), 0].tolist():
                raise AssertionError(f"re-route {topo}: message {val} not delivered")
    after = build.library.cache_info()
    if build.library() is not lib or after.misses != cache.misses or build._digest() != digest:
        raise AssertionError("re-routing rebuilt or reloaded the kernel library")
    log(f"re-route: torus then snake bus on one config, {len(msgs)} messages each, "
        f"delivered, no loss; the kernel library was neither rebuilt nor reloaded")


def phase_injection(dev) -> list[dict]:
    """The paper's Tab. 4 (benchmarks/injection.py): both FIFOs of every
    rank saturated toward the same +y link, switch bubble on; both paths of
    kernel C checked against the plain routers and timed in turns."""
    from repro_torch.core import Communicator, RouterConfig
    from repro_torch.core.router import _fabric
    from repro_torch.kernels.router import router_run, tick_spec_of

    comm = Communicator.create(("x", "y"), DIMS, device=dev)
    tbl = _tables(dev)["torus"]
    _, link_ids, src = _fabric(DIMS, dev)
    rows = []
    for R in (1, 4, 8, 16):
        cfg = RouterConfig(dims=DIMS, n_ports=2, fifo_cap=8, out_cap=32, transit_cap=32, R=R,
                           switch_bubble=True)
        msgs = []
        for r in range(P):
            row, col = divmod(r, 4)
            msgs += [(r, 0, row * 4 + (col + 1) % 4, 0.0)] * 8   # +y, 1 hop
            msgs += [(r, 1, row * 4 + (col + 2) % 4, 0.0)] * 8   # +y twice, 2 hops
        staged = _stage(dev, 2, 8, cfg.pkt_elems, msgs)
        got, ticks = _router_paths(dev, cfg, comm, tbl, *staged, 96, f"injection R={R}")
        delivered, lost = int(got[1].sum()), int(got[2].sum())
        drain = int(got[3].max()) + 1
        if lost:
            raise AssertionError(f"injection R={R}: {lost} packets lost")
        spec = tick_spec_of(cfg, P, link_ids)
        us = {"warp": [], "thread": []}
        for path in ("warp", "thread", "thread", "warp"):
            us[path].append(device_ms(lambda: router_run(spec, tbl, src, *staged, 96,
                                                         path=path)) * 1e3)
        us = {k: sum(v) / len(v) for k, v in us.items()}
        rows.append(dict(R=R, delivered=delivered, drain_ticks=drain, ticks=ticks,
                         ticks_per_packet=drain / (delivered / P), us_per_run_warp=us["warp"],
                         us_per_run_thread=us["thread"]))
        log(f"injection R={R:>2}: delivered {delivered}, drain {drain} ticks ({ticks} run), "
            f"{drain / (delivered / P):.2f} ticks/packet, device time warp {us['warp']:.1f} "
            f"us/run, thread {us['thread']:.1f} us/run, overflow {lost}")
    return rows


def phase_packet_stencil() -> tuple[int, dict]:
    import torch

    from repro_torch.kernels.router import router_run
    from repro_torch.kernels.stencil import stencil_sweep
    from repro_torch.launch import stencil as launch_stencil

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        for sched, extra in (("overlapped", []), ("reference", ["--no-overlap"])):
            out = os.path.join(tmp, f"{sched}.json")
            rc = launch_stencil.main([*PACKET_STENCIL_ARGS, *extra, "--json", out])
            torch.cuda.synchronize()
            res = json.loads(Path(out).read_text())
            if rc != 0 or not res["ok"] or res["max_err"] != 0.0:
                raise AssertionError(f"packet stencil {sched}: rc={rc} result={res}")
            if (res["halo_steps"], res["halo_bytes_per_rank"]) != PACKET_HALO:
                raise AssertionError(f"packet stencil {sched}: halo {res['halo_steps']} steps / "
                                     f"{res['halo_bytes_per_rank']} B, expected {PACKET_HALO}")
            results[sched] = res
        launches_c, launches_b = router_run.launches, stencil_sweep.launches
        warp_c = router_run.warp_launches
    if launches_c == 0 or launches_b == 0 or warp_c != launches_c:
        raise AssertionError(f"packet stencil path launched kernel C {launches_c} times "
                             f"({warp_c} on the warp path) and kernel B {launches_b} times")
    for sched, res in results.items():
        log(f"packet stencil {sched}: {res['wall_per_step_s'] * 1e3:.4f} ms/step, halo "
            f"{res['halo_steps']} steps / {res['halo_bytes_per_rank']} B per rank, equal to "
            f"the single-rank sweep")
    log(f"packet stencil path: kernel C launched {launches_c} times (all on the warp path), "
        f"kernel B {launches_b}")
    return launches_c, results


def phase_packet_reductions(dev) -> dict:
    import torch

    from repro_torch.core import Communicator, snake_bus
    from repro_torch.core.collectives import allreduce, reduce, stream_reduce_scatter
    from repro_torch.kernels.router import router_run
    from repro_torch.transport import get_transport

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((P, REDUCE_ELEMS), generator=g, device=dev)
    ops = {"allreduce": lambda v, c, t: allreduce(v, c, plan=None, transport=t),
           "reduce_scatter": lambda v, c, t: stream_reduce_scatter(v, c, transport=t),
           "reduce": lambda v, c, t: reduce(v, c, root=3, plan=None, transport=t)}
    comms = {"ring(1x8)": Communicator.create(("x",), (8,), device=dev),
             "torus(2x4)": Communicator.create(("x", "y"), DIMS, device=dev),
             "snake_bus(2x4)": Communicator.create(("x", "y"), DIMS, topology=snake_bus(DIMS),
                                                   device=dev)}
    reset_counts()
    for cname, comm in comms.items():
        for name, op in ops.items():
            ts = get_transport("static", device=dev)
            tp = get_transport("packet", device=dev, pkt_elems=2048)
            t0 = time.perf_counter()
            got = op(x, comm, tp)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            want = op(x, comm, ts)
            torch.cuda.synchronize()
            if not same_bits(got, want) or not torch.isfinite(got).all():
                raise AssertionError(f"{name} on {cname}: smi:packet != smi:static")
            if int(tp.stats.overflow.sum()) != 0:
                raise AssertionError(f"{name} on {cname}: packets lost")
            log(f"{name:>14} on {cname:>14}: smi:packet bit-equal to smi:static, overflow 0, "
                f"{tp.stats.steps} router ticks budgeted, {secs * 1e3:.1f} ms")
    launches, warp = router_run.launches, router_run.warp_launches
    if launches == 0 or warp != launches:
        raise AssertionError(f"the packet reductions launched kernel C {launches} times, "
                             f"{warp} on the warp path")
    # 64 ranks, past the warp path's 32: the thread path
    comm = Communicator.create(("x", "y"), (8, 8), device=dev)
    x64 = torch.randn((64, 64 * 1024), generator=g, device=dev)
    tp = get_transport("packet", device=dev, pkt_elems=2048)
    t0 = time.perf_counter()
    got = allreduce(x64, comm, plan=None, transport=tp)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not same_bits(got, allreduce(x64, comm, plan=None,
                                    transport=get_transport("static", device=dev))):
        raise AssertionError("allreduce on torus(8x8): smi:packet != smi:static")
    if int(tp.stats.overflow.sum()) != 0:
        raise AssertionError("allreduce on torus(8x8): packets lost")
    thread = router_run.launches - launches
    if thread == 0 or router_run.warp_launches != warp:
        raise AssertionError(f"the 64-rank allreduce launched kernel C {thread} times, "
                             f"{router_run.warp_launches - warp} on the warp path")
    log(f"     allreduce on     torus(8x8): smi:packet bit-equal to smi:static, overflow 0, "
        f"{tp.stats.steps} router ticks budgeted, {secs * 1e3:.1f} ms")
    log(f"packet reduction path: kernel C launched {launches} times on the warp path (8 ranks) "
        f"and {thread} times on the thread path (64 ranks)")
    return {"warp": launches, "thread": thread}


# -- the dense model: flash attention (kernel E), prefill, serving ---------------------

#: yi-6b's attention at the prefill shape: one sequence of 4096 tokens, its
#: 32 query heads over KV heads expanded to 32 (the model path), head dim 128
PREFILL_TOKENS = 4096
#: kernel E's cases: (name, BH, H, Hkv, Sq, Skv, skv_actual, D, causal, window,
#: dtype); Sq and Skv are the wrapper's padded lengths.  bfloat16 runs on the
#: wgmma kernel, float32 on the FMA one: each bfloat16 shape is there in
#: float32 too, and D = 16 (padded to 64) and an Sq that is a multiple of 64
#: but not of 128 (the wgmma kernel's query block) are bfloat16 only
FA_CASES = (
    ("prefill_bf16_causal", 32, 32, 32, 4096, 4096, 4096, 128, True, None, "bfloat16"),
    ("gqa_32_4_f32_ragged", 32, 32, 4, 1024, 1024, 1000, 128, True, None, "float32"),
    ("sq256_skv1024_f32", 32, 32, 32, 256, 1024, 1024, 128, True, None, "float32"),
    ("window2048_d256_f32", 16, 16, 16, 4096, 4096, 4096, 256, True, 2048, "float32"),
    ("noncausal_f32", 32, 32, 32, 1024, 1024, 1024, 128, False, None, "float32"),
    ("gqa_32_4_bf16_ragged", 32, 32, 4, 1024, 1024, 1000, 128, True, None, "bfloat16"),
    ("sq256_skv1024_bf16", 32, 32, 32, 256, 1024, 1024, 128, True, None, "bfloat16"),
    ("window2048_d256_bf16", 16, 16, 16, 4096, 4096, 4096, 256, True, 2048, "bfloat16"),
    ("noncausal_bf16", 32, 32, 32, 1024, 1024, 1024, 128, False, None, "bfloat16"),
    ("d16_padded_bf16", 32, 32, 8, 1024, 1024, 1000, 16, True, None, "bfloat16"),
    ("sq4032_bf16", 32, 32, 32, 4032, 4032, 4032, 128, True, None, "bfloat16"),
    # slice 10's prefills at 4096 positions: internvl2-1b (14 heads, their KV
    # expanded; at P = 8 the 8 ranks' 2 padded heads) and musicgen-medium (24
    # heads) at head dim 64, recurrentgemma-9b's 8 ranks x 2 heads at head dim
    # 256 with its 2048-token window (its tp = 1 shape is window2048_d256)
    ("vlm_d64_bf16", 14, 14, 14, 4096, 4096, 4096, 64, True, None, "bfloat16"),
    ("vlm_d64_f32", 14, 14, 14, 4096, 4096, 4096, 64, True, None, "float32"),
    ("vlm_tp8_d64_bf16", 16, 2, 2, 4096, 4096, 4096, 64, True, None, "bfloat16"),
    ("audio_d64_bf16", 24, 24, 24, 4096, 4096, 4096, 64, True, None, "bfloat16"),
    ("audio_d64_f32", 24, 24, 24, 4096, 4096, 4096, 64, True, None, "float32"),
    ("rg_tp8_window2048_d256_bf16", 16, 2, 2, 4096, 4096, 4096, 256, True, 2048, "bfloat16"),
    # slice 12's (2, 4) training: a data group's yi-6b at tp = 4, 8 query
    # heads and 1 KV head a rank over 4096 positions
    ("train_tp4_gqa8_bf16", 32, 8, 1, 4096, 4096, 4096, 128, True, None, "bfloat16"),
    # slice 14's (2, 2, 2) training: a data group's yi-6b at tp = 2 over one
    # 4096-token sequence, 16 query heads a rank over their KV heads expanded
    # (the model path), and over 2 KV heads (yi-6b's GQA map of a rank)
    ("train_tp2_bf16", 32, 16, 16, 4096, 4096, 4096, 128, True, None, "bfloat16"),
    ("train_tp2_gqa16_bf16", 32, 16, 2, 4096, 4096, 4096, 128, True, None, "bfloat16"),
)
FA_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}


def _fa_inputs(dev, g, BH, Hkv_rows, Sq, Skv, skv, D, dtype):
    """Unit-normal q, k, v in the kernel's padded layout; keys past ``skv``
    are zero, as the wrapper's padding leaves them."""
    import torch

    q = torch.randn((BH, Sq, D), generator=g, device=dev)
    k = torch.randn((Hkv_rows, Skv, D), generator=g, device=dev)
    v = torch.randn((Hkv_rows, Skv, D), generator=g, device=dev)
    k[:, skv:] = 0
    v[:, skv:] = 0
    dt = getattr(torch, dtype)
    return q.to(dt), k.to(dt), v.to(dt)


def phase_flash_kernel(dev) -> tuple[float, dict]:
    """Kernel E against its plain version on the cases of ``FA_CASES``, each
    on the path its dtype picks (the wgmma counter moves for exactly the
    bfloat16 cases); returns the worst error and the prefill-shape timing
    row (CUDA events): kernel E on its wgmma path, the FMA kernel that ran
    bfloat16 before it on the same inputs (``ms_before``), the plain version
    and ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_kernel, flash_attention_plain
    from repro_torch.kernels.flash_attention.kernel import launch_flash_attention

    g = torch.Generator(device=dev).manual_seed(12)
    worst = {}
    row = None
    for name, BH, H, Hkv, Sq, Skv, skv, D, causal, window, dtype in FA_CASES:
        q, k, v = _fa_inputs(dev, g, BH, BH // H * Hkv, Sq, Skv, skv, D, dtype)
        kw = dict(n_q_heads=H, n_kv_heads=Hkv, scale=D ** -0.5, causal=causal, window=window,
                  skv_actual=skv)
        path = "wgmma" if dtype == "bfloat16" else "fma"
        before = flash_attention_kernel.wgmma_launches
        got = flash_attention_kernel(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if flash_attention_kernel.wgmma_launches != before + (path == "wgmma"):
            raise AssertionError(f"flash_attention {name}: the {path} path was not taken")
        err = max_abs_err(got, want)
        if not torch.isfinite(got).all() or err > FA_TOL[dtype]:
            raise AssertionError(f"flash_attention {name}: kernel != plain (max abs err {err}, "
                                 f"tolerance {FA_TOL[dtype]})")
        worst[dtype] = max(worst.get(dtype, 0.0), err)
        log(f"flash_attention {name:>22} ({path}): max abs err {err:.3e} "
            f"(tolerance {FA_TOL[dtype]})")
        if name == "prefill_bf16_causal":
            ms = time_ms(lambda: flash_attention_kernel(q, k, v, **kw), reps=20)
            out = torch.empty_like(q)
            ms_fma = time_ms(lambda: launch_flash_attention(
                q, k, v, out, n_q_heads=H, n_kv_heads=Hkv, scale=D ** -0.5, causal=True,
                window=None, skv=skv, path="fma"), reps=5, warmup=1)
            err_fma = max_abs_err(out, want)
            plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw), reps=3, warmup=1)
            q4, k4, v4 = (t.view(1, BH, Sq, D) for t in (q, k, v))
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
                              reps=20)
            # this run's data: every query sees the keys at or before it
            pairs = BH * Sq * (Sq + 1) // 2
            t_bound, by = bound(4 * q.numel() * q.element_size(), 4 * D * pairs, BF16_OPS_PER_S)
            row = dict(name="flash_attention", route="cuda",
                       source="src/repro_torch/csrc/flash_attention.cu",
                       replaces="src/repro/kernels/flash_attention/kernel.py:88", launches=0,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                       library_ms=sdpa_ms, path="wgmma", ms_before=ms_fma,
                       max_abs_err_before=err_fma, shape=list(q.shape), dtype=dtype, causal=True)
            log(f"flash_attention prefill shape {list(q.shape)} bf16 causal: wgmma {ms:.4f} ms "
                f"({4 * D * pairs / ms / 1e9:.1f} TFLOP/s), the FMA kernel {ms_fma:.4f} ms, "
                f"plain {plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms, bound {t_bound:.4f} ms ({by})")
            del out
        del q, k, v, got, want
    row["max_abs_err_by_dtype"] = worst
    return max(worst.values()), row


def _profile_device_ms(fn) -> tuple[float, list[tuple[str, float]], float]:
    """Device milliseconds of one call of ``fn`` under ``torch.profiler``:
    the total over kernels, the rows by kernel name, largest first, and the
    host clock's milliseconds of the same call (to its last kernel's end)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda kv: -kv[1])
    return sum(ms for _, ms in rows), rows, wall


def phase_prefill(dev, arch: str = "yi-6b", kernel: str = "E", seed: int = 13
                  ) -> tuple[int, dict]:
    """``arch`` at full width and depth (bfloat16, random weights from a
    seeded generator) through ``build_prefill`` on one sequence of 4096
    seeded tokens: a warm-up run, a timed run whose launches of ``kernel``
    (E: flash attention, F: the SSD scan) are counted (one per layer), a
    profiled run (the kernel's share of the device time), and the same
    prefill with ``use_kernel=False`` (the plain versions).  For E every
    row's cosine similarity must be at least 0.999.  For F the bfloat16
    comparison is reported, not gated: 64 random SSM layers amplify bfloat16
    rounding (two plain runs that differ only in the scan's chunk differ as
    much, also reported); :func:`_ssm_checks` gates F instead."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd import ssd_scan_kernel
    from repro_torch.launch.steps import build_prefill
    from repro_torch.models import init_lm
    from repro_torch.models.common import tree_leaves_with_path
    from repro_torch.models.model import model_dtype

    wrapper, kernel_name = {"E": (flash_attention_kernel, "flash_attention"),
                            "F": (ssd_scan_kernel, "ssd_scan")}[kernel]
    cfg = get_arch(arch)
    shape = ShapeConfig("prefill_4k", PREFILL_TOKENS, 1, "prefill")
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                     dtype=model_dtype(cfg))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves_with_path(params))
    log(f"prefill: {cfg.name} params {n_params} ({n_params * 2 / 1e9:.2f} GB bf16) initialised "
        f"on the card in {time.perf_counter() - t0:.1f}s")
    prefill = build_prefill(cfg, shape, device=dev)
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                  (1, PREFILL_TOKENS)))
    prefill(params, tokens)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hidden = prefill(params, tokens)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    state_bytes = sum(t.nbytes for _, t in tree_leaves_with_path(params))
    launches = wrapper.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"{cfg.name} prefill launched kernel {kernel} {launches} times, "
                             f"not {cfg.n_layers}")
    if wrapper.wgmma_launches != launches:
        raise AssertionError(f"{cfg.name} prefill: {wrapper.wgmma_launches} of kernel "
                             f"{kernel}'s {launches} launches took the wgmma path")
    if tuple(hidden.shape) != (1, PREFILL_TOKENS, cfg.d_model) or not torch.isfinite(hidden).all():
        raise AssertionError(f"prefill hidden states {tuple(hidden.shape)} not finite or "
                             f"not (1, {PREFILL_TOKENS}, {cfg.d_model})")
    on_wgmma = f" ({wrapper.wgmma_launches} on wgmma)"
    busy, rows, prof_wall = _profile_device_ms(lambda: prefill(params, tokens))
    k_ms = sum(t for name, t in rows if kernel_name in name)
    # device time and wall of the one profiled run, unclamped: a device time
    # above the wall (kernels on overlapping streams) shows as a negative
    # share and is named in the log
    idle = 1 - busy / prof_wall
    overlap = " (device time exceeds the wall)" if busy > prof_wall else ""
    plain = prefill(params, tokens, use_kernel=False)
    torch.cuda.synchronize()
    cos = F.cosine_similarity(hidden[0].float(), plain[0].float(), dim=-1)
    err = max_abs_err(hidden, plain)
    log(f"prefill: {cfg.name} {ms:.3f} ms for {PREFILL_TOKENS} tokens "
        f"({PREFILL_TOKENS / ms * 1e3:.1f} tok/s), kernel {kernel} launched {launches} times"
        f"{on_wgmma}; "
        f"profiled device time {busy:.3f} ms, kernel {kernel} {k_ms:.3f} ms ({k_ms / busy:.1%}); "
        f"profiled wall {prof_wall:.3f} ms, device idle {idle:.1%} of it{overlap}")
    for name, t in rows[:8]:
        log(f"prefill profile: {t:9.3f} ms  {name[:90]}")
    log(f"prefill vs use_kernel=False: min row cosine {float(cos.min()):.6f}, max abs diff {err:.4g}")
    res = dict(ms=ms, tok_per_s=PREFILL_TOKENS / ms * 1e3, device_ms=busy, kernel_ms=k_ms,
               kernel_share=k_ms / busy, profiled_wall_ms=prof_wall,
               device_idle_share=idle, min_cos=float(cos.min()),
               max_abs_diff=err, params=n_params, state_bytes=state_bytes,
               peak_bytes=peak)
    if kernel == "E" and float(cos.min()) < 0.999:
        raise AssertionError(f"prefill hidden states disagree with the plain run: min row cosine "
                             f"{float(cos.min())}")
    if kernel == "F":
        del plain
        res.update(_ssm_checks(dev, cfg, params, tokens, prefill, hidden, seed))
    res["decode"] = _decode_profile(cfg, params)
    return launches, res


def _row_cos(a, b):
    """Each row's cosine similarity of two (1, S, D) tensors, in float32."""
    import torch.nn.functional as F

    return F.cosine_similarity(a[0].float(), b[0].float(), dim=-1)


def _ssm_checks(dev, cfg, params, tokens, prefill, hidden, seed) -> dict:
    """What gates kernel F on the mamba2 prefill path:

    * layer by layer at full depth in bfloat16: each block's update (its
      output less its input) from the kernel run's own input, with F and
      with the plain scan; every row's cosine at least 0.999 in every
      layer;
    * end to end in float32 (the same seeded weights, drawn in float32),
      F against the plain scan: every row's cosine at least 0.999, each of
      its launches (one a layer, counted from 0) on the FMA kernel.

    Reported beside them: the bfloat16 prefill with the plain scan at chunk
    64 against chunk 128, the rounding noise of two right answers."""
    from unittest import mock

    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels.ssd import ssd_scan_kernel
    from repro_torch.launch.steps import build_prefill
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import init_lm
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.model import embed_tokens_sp
    from repro_torch.models.transformer import _layer, apply_block

    ctx = make_ctx()
    x = embed_tokens_sp(params, tokens.to(dev), cfg, ctx)
    worst_layer = (1.0, -1)
    for i in range(cfg.n_layers):
        p = _layer(params["stack"]["periods"][0], i)
        got, _ = apply_block(p, "ssm", x, cfg, ctx, use_kernel=True)
        want, _ = apply_block(p, "ssm", x, cfg, ctx, use_kernel=False)
        c = float(_row_cos(got - x, want - x).min())
        worst_layer = min(worst_layer, (c, i))
        x = got
    torch.cuda.synchronize()
    log(f"prefill per layer (bf16, F vs plain on each layer's own input): min row cosine "
        f"{worst_layer[0]:.6f} (layer {worst_layer[1]})")
    if worst_layer[0] < 0.999:
        raise AssertionError(f"layer {worst_layer[1]}: F's block update disagrees with the plain "
                             f"scan's, min row cosine {worst_layer[0]}")
    del x, got, want

    plain128 = prefill(params, tokens, use_kernel=False)
    with mock.patch.object(ssm_mod, "SSD_CHUNK", 64):
        plain64 = prefill(params, tokens, use_kernel=False)
    torch.cuda.synchronize()
    noise = float(_row_cos(plain64, plain128).min())
    log(f"prefill noise (bf16, plain scan chunk 64 vs chunk 128): min row cosine {noise:.6f}; "
        f"F vs plain: {float(_row_cos(hidden, plain128).min()):.6f}")
    del plain128, plain64

    cfg32 = cfg.scaled(dtype="float32")
    params32 = init_lm(cfg32, torch.Generator(device=dev).manual_seed(seed), dev,
                       dtype=torch.float32)
    prefill32 = build_prefill(cfg32, ShapeConfig("prefill_4k", PREFILL_TOKENS, 1, "prefill"),
                              device=dev)
    reset_counts()
    got32 = prefill32(params32, tokens)
    torch.cuda.synchronize()
    launches32, wgmma32 = ssd_scan_kernel.launches, ssd_scan_kernel.wgmma_launches
    if launches32 != cfg.n_layers or wgmma32:
        raise AssertionError(f"float32 prefill: kernel F launched {launches32} times, "
                             f"{wgmma32} on wgmma; want {cfg.n_layers}, all on the FMA kernel")
    want32 = prefill32(params32, tokens, use_kernel=False)
    torch.cuda.synchronize()
    cos32 = float(_row_cos(got32, want32).min())
    err32 = max_abs_err(got32, want32)
    log(f"prefill float32 end to end, F vs plain: min row cosine {cos32:.8f}, max abs diff "
        f"{err32:.4g}; kernel F launched {launches32} times, all on the FMA kernel")
    if not torch.isfinite(got32).all() or cos32 < 0.999:
        raise AssertionError(f"float32 prefill with F disagrees with the plain scan: min row "
                             f"cosine {cos32}")
    return dict(min_cos_per_layer=worst_layer[0], bf16_noise_min_cos=noise, f32_min_cos=cos32,
                f32_max_abs_diff=err32, f32_fma_launches=launches32)


def _decode_profile(cfg, params, n_ticks: int = 8) -> dict:
    """Where a decode step's time goes: the continuous engine's tick with
    the serving phase's 4 slots and 256 positions, on these params; wall ms
    per tick (host clock, no profiler) against device-busy ms per tick
    (``torch.profiler``)."""
    import torch

    from repro_torch.serving import ContinuousEngine, Request

    eng = ContinuousEngine(cfg, params, batch_slots=4, capacity=256)
    for uid in range(4):
        eng.submit(Request(uid=uid, prompt=[1 + uid, 2, 3], max_new=10 * n_ticks))
    for _ in range(4):
        eng.tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        eng.tick()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_ticks
    busy, rows, _ = _profile_device_ms(lambda: [eng.tick() for _ in range(n_ticks)])
    busy /= n_ticks
    log(f"decode tick (4 slots, 256 positions): wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"(idle {max(0.0, 1 - busy / wall):.1%})")
    for name, t in rows[:6]:
        log(f"decode profile: {t / n_ticks:8.3f} ms/tick  {name[:90]}")
    return dict(wall_ms=wall, device_ms=busy)


#: the serving phases: full width, random weights, both engines
SERVE_ARGS = ["--requests", "8", "--max-new", "16", "--slots", "4", "--capacity", "256"]


def phase_serving(arch: str = "yi-6b") -> dict:
    """``launch.serve --arch arch`` with the wave engine, then the
    continuous engine: every request's tokens equal across the two."""
    import torch

    from repro_torch.launch import serve as launch_serve

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for engine in ("wave", "continuous"):
            out = os.path.join(tmp, f"{engine}.json")
            rc = launch_serve.main(["--arch", arch, *SERVE_ARGS, "--engine", engine,
                                    "--json", out])
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            res = json.loads(Path(out).read_text())
            if rc != 0 or res["completed"] != res["requests"]:
                raise AssertionError(f"serve {engine}: rc={rc}, {res['completed']} of "
                                     f"{res['requests']} requests completed")
            results[engine] = res
            log(f"serve {arch} {engine}: {res['tokens']} tokens in {res['seconds']:.3f}s "
                f"({res['tok_per_s']:.1f} tok/s), {res['decode_steps']} decode steps "
                f"({res['ms_per_step']:.3f} ms/step)")
    if results["wave"]["out"] != results["continuous"]["out"]:
        raise AssertionError("the wave and continuous engines emitted different tokens: "
                             f"{results['wave']['out']} != {results['continuous']['out']}")
    log(f"serve {arch}: wave and continuous tokens equal for all {len(results['wave']['out'])} "
        f"requests")
    return results


# -- mamba2: the SSD scan (kernel F) ---------------------------------------------------

#: kernel F's cases: (name, BH, S, Dh, Dst, G, chunk, dtype, entry, path); B
#: and C have G rows shared by BH / G heads; ``entry`` goes through the
#: padding entry point ``ssd_scan`` (S need not be a multiple of the chunk);
#: ``path`` is the kernel the case must run (``ssd_path``'s pick)
SSD_CASES = (
    ("prefill_bf16_shared_bc", 80, 4096, 64, 128, 1, 128, "bfloat16", False, "wgmma"),
    ("prefill_f32_shared_bc", 80, 4096, 64, 128, 1, 128, "float32", False, "fma"),
    ("broadcast_layout_f32", 32, 2048, 64, 128, 32, 128, "float32", False, "fma"),
    ("chunk64_f32", 16, 1024, 64, 128, 16, 64, "float32", False, "fma"),
    ("one_chunk_bf16", 8, 128, 64, 128, 1, 128, "bfloat16", False, "wgmma"),
    ("s640_five_chunks_bf16", 16, 640, 64, 128, 2, 128, "bfloat16", False, "wgmma"),
    ("ragged_s1000_bf16", 16, 1000, 64, 128, 2, 128, "bfloat16", True, "wgmma"),
    ("small_vs_sequential_f32", 4, 256, 16, 8, 4, 64, "float32", True, "fma"),
    # slice 12's (2, 4) training: a data group's mamba2-2.7b at tp = 4, 20
    # heads a rank, one B/C row a rank
    ("train_tp4_bf16", 80, 4096, 64, 128, 4, 128, "bfloat16", False, "wgmma"),
)
SSD_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
#: the wgmma path against the plain version, both bfloat16: the mean over
#: rows of |y - y_plain| / |y_plain|.  Kept float32 sums round y as the
#: plain version does; scores rounded once to bf16 move ~a third of the
#: elements by an ulp (``tests/test_torch_ssd.py``, ``ROUNDING_LIMIT``)
SSD_ROUNDING_LIMIT = 1e-3
#: against the sequential recurrence, which sums in another order (the
#: reference's own kernel test holds its Pallas scan to 2e-4)
SSD_SEQ_TOL = 2e-4


def _ssd_inputs(dev, g, BH, S, Dh, Dst, G, dtype):
    """x, B, C ``0.5 randn``, dt uniform in [0.05, 0.55), A ``-exp(0.3
    randn)`` (the reference's test distributions), in ``dtype``."""
    import torch

    x = torch.randn((BH, S, Dh), generator=g, device=dev) * 0.5
    dt = torch.rand((BH, S), generator=g, device=dev) * 0.5 + 0.05
    B = torch.randn((G, S, Dst), generator=g, device=dev) * 0.5
    C = torch.randn((G, S, Dst), generator=g, device=dev) * 0.5
    A = -torch.exp(torch.randn((BH, 1), generator=g, device=dev) * 0.3)
    dt_ = getattr(torch, dtype)
    return [t.to(dt_) for t in (x, dt, B, C, A)]


def _ssd_bound(x, dt, B, C, A, chunk: int) -> tuple[float, str]:
    """The least time for one scan: each input read once and the output
    written once, against the causal products of the chunked form (the
    lower triangle of C B^T and of scores . xd, C . h_in and the state
    update) at the card's peak for the inputs' type (the bf16 tensor cores,
    or float32 outside them)."""
    import torch

    BH, S, Dh = x.shape
    Dst = B.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (x, dt, B, C, A)) \
        + x.numel() * x.element_size()
    L = chunk
    flop_per_chunk = 2 * (L * (L + 1) // 2 * (Dst + Dh) + 2 * L * Dst * Dh)
    rate = BF16_OPS_PER_S if x.dtype == torch.bfloat16 else F32_OPS_PER_S
    return bound(nbytes, flop_per_chunk * BH * (S // L), rate)


def phase_ssd_kernel(dev) -> tuple[float, dict]:
    """Kernel F against its plain version on the cases of ``SSD_CASES``, each
    on the path it names (the counters move for exactly that path; the
    wgmma cases also within ``SSD_ROUNDING_LIMIT``); returns the worst
    relative error and the prefill-shape timing rows by path (CUDA events;
    no single PyTorch call computes an SSD scan): the wgmma path in
    bfloat16, beside the FMA kernel on the same inputs (``ms_before``), and
    the FMA kernel in float32, each on the kernel's layout, beside the
    wrapper (its dtype conversions included) and the plain version."""
    import torch

    from repro_torch.kernels.ssd import ssd_ref, ssd_scan, ssd_scan_kernel, ssd_scan_plain
    from repro_torch.kernels.ssd.kernel import launch_ssd_scan

    g = torch.Generator(device=dev).manual_seed(15)
    worst, rows, rounding = {}, {}, 0.0
    for name, BH, S, Dh, Dst, G, chunk, dtype, entry, path in SSD_CASES:
        x, dt, B, C, A = _ssd_inputs(dev, g, BH, S, Dh, Dst, G, dtype)
        before, before_w = ssd_scan_kernel.launches, ssd_scan_kernel.wgmma_launches
        if entry:
            got = ssd_scan(x, dt, B, C, A, chunk=chunk)
            want = ssd_scan(x, dt, B, C, A, chunk=chunk, use_kernel=False)
        else:
            got = ssd_scan_kernel(x, dt, B, C, A, chunk=chunk)
            want = ssd_scan_plain(x, dt, B, C, A, chunk=chunk)
        torch.cuda.synchronize()
        if ssd_scan_kernel.launches != before + 1 \
                or ssd_scan_kernel.wgmma_launches != before_w + (path == "wgmma"):
            raise AssertionError(f"ssd_scan {name}: kernel F did not launch once on its "
                                 f"{path} path")
        mag = float(want.abs().max())
        err = max_abs_err(got, want)
        if tuple(got.shape) != (BH, S, Dh) or not torch.isfinite(got).all() \
                or err > SSD_TOL[dtype] * mag:
            raise AssertionError(f"ssd_scan {name} ({path}): kernel != plain (max abs err "
                                 f"{err}, tolerance {SSD_TOL[dtype]} x {mag})")
        worst[dtype] = max(worst.get(dtype, 0.0), err / mag)
        msg = ""
        if path == "wgmma":
            reading = _mean_row_rel_err(got, want)
            if reading > SSD_ROUNDING_LIMIT:
                raise AssertionError(f"ssd_scan {name} (wgmma): mean row relative error "
                                     f"{reading} against the plain version > "
                                     f"{SSD_ROUNDING_LIMIT}")
            rounding = max(rounding, reading)
            msg = f"; mean row relative error {reading:.3e} (limit {SSD_ROUNDING_LIMIT})"
        log(f"ssd_scan {name:>24} ({path}): max abs err {err:.3e} of {mag:.3g} (tolerance "
            f"{SSD_TOL[dtype]} of it){msg}")
        if name.startswith("small_vs_sequential"):
            seq = ssd_ref(x, dt, B, C, A)
            torch.cuda.synchronize()
            err_seq = max_abs_err(got, seq)
            if err_seq > SSD_SEQ_TOL * float(seq.abs().max()):
                raise AssertionError(f"ssd_scan {name}: kernel != ssd_ref (max abs err {err_seq})")
            log(f"ssd_scan {name:>24}: against the sequential ssd_ref, max abs err {err_seq:.3e}")
        if name.startswith("prefill"):
            # the kernels on their layout (dt and A in float32, as the wrapper
            # hands them over); the wrapper's own time, conversions included,
            # beside them
            dt32, A32, out = dt.float(), A.float().reshape(-1), torch.empty_like(x)

            def run(path_):
                return launch_ssd_scan(x, dt32, B, C, A32, out, chunk=chunk, path=path_)

            ms = time_ms(lambda: run(path), reps=20)
            wrapper_ms = time_ms(lambda: ssd_scan_kernel(x, dt, B, C, A, chunk=chunk), reps=20)
            plain_ms = time_ms(lambda: ssd_scan_plain(x, dt, B, C, A, chunk=chunk), reps=3,
                               warmup=1)
            t_bound, by = _ssd_bound(x, dt, B, C, A, chunk)
            row = dict(name="ssd_scan", route="cuda", path=path,
                       source="src/repro_torch/csrc/ssd.cu",
                       replaces="src/repro/kernels/ssd/kernel.py:80", launches=0,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                       library_ms=None, wrapper_ms=wrapper_ms, shape=list(x.shape), state=Dst,
                       bc_rows=G, chunk=chunk, dtype=dtype)
            before_msg = ""
            if path == "wgmma":  # the FMA kernel on the same bfloat16 inputs
                ms_fma = time_ms(lambda: run("fma"), reps=5, warmup=1)
                err_fma = max_abs_err(out, want)
                row.update(ms_before=ms_fma, max_abs_err_before=err_fma)
                before_msg = f", the FMA kernel {ms_fma:.4f} ms"
            del out
            rows[path] = row
            log(f"ssd_scan prefill shape {list(x.shape)} state {Dst} {dtype} ({path}): kernel "
                f"{ms:.4f} ms{before_msg}, the wrapper {wrapper_ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {t_bound:.4f} ms ({by})")
        del x, dt, B, C, A, got, want
    # the scores' precision at the prefill shape on a mamba2-2.7b layer's dt
    # range, uniform in [0.01, 3.7), with A = -1
    x, _, B, C, A = _ssd_inputs(dev, g, 80, 4096, 64, 128, 1, "bfloat16")
    dt = (0.01 + torch.rand((80, 4096), generator=g, device=dev) * 3.69).to(torch.bfloat16)
    A = -torch.ones_like(A)
    got = ssd_scan_kernel(x, dt, B, C, A)
    layer_reading = _mean_row_rel_err(got, ssd_scan_plain(x, dt, B, C, A))
    log(f"ssd_scan prefill shape, a layer's dt range (wgmma): mean row relative error "
        f"{layer_reading:.3e} (limit {SSD_ROUNDING_LIMIT})")
    if layer_reading > SSD_ROUNDING_LIMIT:
        raise AssertionError(f"ssd_scan on a layer's dt range (wgmma): mean row relative error "
                             f"{layer_reading} > {SSD_ROUNDING_LIMIT}")
    for row in rows.values():
        row["max_rel_err_by_dtype"] = worst
    rows["wgmma"].update(max_mean_row_rel_err=rounding, mean_row_rel_err_layer_dt=layer_reading)
    return max(worst.values()), rows


def _mean_row_rel_err(got, want) -> float:
    """The mean over rows of |got - want| / |want| (the last dim a row)."""
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).mean())


# -- tensor parallelism: the per-chunk GEMM (kernel D) and the TP prefill ---------------

#: kernel D's cases: (name, x shape, w shape, dtype, strided, path); the first
#: four are the yi-6b TP prefill's ring steps at P = 8 (512 rows a rank): Q,
#: MLP-up (ragged N = 1376), MLP-down (ragged K = 1376) and the
#: out-projection; the next four slice 9's: mamba2-2.7b's ``ssm.in`` and
#: ``ssm.out``, qwen3-moe-30b-a3b's Q and out-projection; the next ten slice
#: 10's: recurrentgemma-9b's MLP-up and down (its ``ssm.in`` and ``ssm.out``,
#: Q and out-projection are yi-6b's Q and out shapes), internvl2-1b's Q,
#: out-projection, MLP-up (the ragged N = 608) and down, musicgen-medium's Q
#: (N = 192), out-projection, MLP-up and down; ``strided`` hands
#: D views (every other rank row of a buffer, a transposed weight); ``path``
#: is the kernel ``matmul_path`` picks
#: (bfloat16 with K and N multiples of 8 on wgmma, the rest on mma.sync)
MM_CASES = (
    ("mlp_up_bf16", (8, 512, 4096), (8, 4096, 1376), "bfloat16", False, "wgmma"),
    ("q_bf16", (8, 512, 4096), (8, 4096, 512), "bfloat16", False, "wgmma"),
    ("mlp_down_bf16", (8, 512, 1376), (8, 1376, 4096), "bfloat16", False, "wgmma"),
    ("out_bf16", (8, 512, 512), (8, 512, 4096), "bfloat16", False, "wgmma"),
    ("ssm_in_bf16", (8, 512, 2560), (8, 2560, 640), "bfloat16", False, "wgmma"),
    ("ssm_out_bf16", (8, 512, 640), (8, 640, 2560), "bfloat16", False, "wgmma"),
    ("moe_q_bf16", (8, 512, 2048), (8, 2048, 512), "bfloat16", False, "wgmma"),
    ("moe_out_bf16", (8, 512, 512), (8, 512, 2048), "bfloat16", False, "wgmma"),
    ("rg_mlp_up_bf16", (8, 512, 4096), (8, 4096, 1536), "bfloat16", False, "wgmma"),
    ("rg_mlp_down_bf16", (8, 512, 1536), (8, 1536, 4096), "bfloat16", False, "wgmma"),
    ("vlm_q_bf16", (8, 512, 896), (8, 896, 128), "bfloat16", False, "wgmma"),
    ("vlm_out_bf16", (8, 512, 128), (8, 128, 896), "bfloat16", False, "wgmma"),
    ("vlm_mlp_up_bf16", (8, 512, 896), (8, 896, 608), "bfloat16", False, "wgmma"),
    ("vlm_mlp_down_bf16", (8, 512, 608), (8, 608, 896), "bfloat16", False, "wgmma"),
    ("audio_q_bf16", (8, 512, 1536), (8, 1536, 192), "bfloat16", False, "wgmma"),
    ("audio_out_bf16", (8, 512, 192), (8, 192, 1536), "bfloat16", False, "wgmma"),
    ("audio_mlp_up_bf16", (8, 512, 1536), (8, 1536, 768), "bfloat16", False, "wgmma"),
    ("audio_mlp_down_bf16", (8, 512, 768), (8, 768, 1536), "bfloat16", False, "wgmma"),
    ("mlp_up_f32", (8, 512, 4096), (8, 4096, 1376), "float32", False, "mma_sync"),
    ("ragged_2d_f32", (100, 70), (70, 50), "float32", False, "mma_sync"),
    ("ragged_2d_bf16", (1000, 130), (130, 333), "bfloat16", False, "mma_sync"),
    ("odd_k_bf16", (3, 65, 131), (3, 131, 33), "bfloat16", False, "mma_sync"),
    ("strided_batch_bf16", (8, 512, 1024), (8, 1024, 1376), "bfloat16", True, "wgmma"),
    ("shared_w_bf16", (8, 512, 1024), (1024, 1376), "bfloat16", False, "wgmma"),
    # slice 12: a data group's ring steps at tp = 4 (1,024 rows a rank) for
    # yi-6b (Q, out, MLP up and down) and mamba2-2.7b (ssm.in, ssm.out), and
    # the GPipe stage product of phase 51
    ("yi_tp4_q_bf16", (4, 1024, 4096), (4, 4096, 1024), "bfloat16", False, "wgmma"),
    ("yi_tp4_out_bf16", (4, 1024, 1024), (4, 1024, 4096), "bfloat16", False, "wgmma"),
    ("yi_tp4_mlp_up_bf16", (4, 1024, 4096), (4, 4096, 2752), "bfloat16", False, "wgmma"),
    ("yi_tp4_mlp_down_bf16", (4, 1024, 2752), (4, 2752, 4096), "bfloat16", False, "wgmma"),
    ("ssm_tp4_in_bf16", (4, 1024, 2560), (4, 2560, 1280), "bfloat16", False, "wgmma"),
    ("ssm_tp4_out_bf16", (4, 1024, 1280), (4, 1280, 2560), "bfloat16", False, "wgmma"),
    ("pipe_stage_bf16", (8, 512, 4096), (8, 4096, 4096), "bfloat16", False, "wgmma"),
    # slice 14: a data group's ring steps at tp = 2 (2,048 rows a rank) for
    # yi-6b at (2, 2, 2): Q, out, MLP up and down
    ("yi_tp2_q_bf16", (2, 2048, 4096), (2, 4096, 2048), "bfloat16", False, "wgmma"),
    ("yi_tp2_out_bf16", (2, 2048, 2048), (2, 2048, 4096), "bfloat16", False, "wgmma"),
    ("yi_tp2_mlp_up_bf16", (2, 2048, 4096), (2, 4096, 5504), "bfloat16", False, "wgmma"),
    ("yi_tp2_mlp_down_bf16", (2, 2048, 5504), (2, 5504, 4096), "bfloat16", False, "wgmma"),
)
MM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the TP prefill's tensor-parallel degree: the paper's 8-rank testbed
TP = 8


def _mm_bound(x, w, out) -> tuple[float, str]:
    """The least time for one product: each operand read once and the
    output written once, against 2 M N K operations per batch entry on the
    bf16 tensor cores (or float32 outside them)."""
    Bt = x.shape[0] if x.dim() == 3 else 1
    ops = 2 * Bt * x.shape[-2] * x.shape[-1] * w.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, out))
    return bound(nbytes, ops, F32_OPS_PER_S if x.element_size() == 4 else BF16_OPS_PER_S)


def phase_matmul_kernel(dev) -> tuple[float, dict]:
    """Kernel D against its plain version on the cases of ``MM_CASES``, each
    on its path (the wgmma counter moves for exactly the wgmma cases);
    returns the worst relative error and the MLP-up timing row (CUDA
    events): D on its wgmma path, the mma.sync kernel that ran it before on
    the same operands (``ms_before``), the plain version and
    ``torch.matmul``; beside it every ring-step shape's time on both paths
    and on the wgmma path's two grids (persistent, one CTA a tile)."""
    import torch

    from repro_torch.kernels.matmul import matmul, matmul_ref
    from repro_torch.kernels.matmul.kernel import launch_matmul

    g = torch.Generator(device=dev).manual_seed(18)
    worst, row, shapes_ms = {}, None, {}
    for name, xs, ws, dtype, strided, path in MM_CASES:
        dt = getattr(torch, dtype)
        if strided:
            x = torch.randn((2 * xs[0],) + xs[1:], generator=g, device=dev).to(dt)[::2]
            w = torch.randn(ws[:1] + ws[:0:-1], generator=g, device=dev).to(dt).transpose(1, 2)
        else:
            x = torch.randn(xs, generator=g, device=dev).to(dt)
            w = torch.randn(ws, generator=g, device=dev).to(dt)
        before, before_wg = matmul.launches, matmul.wgmma_launches
        got = matmul(x, w)
        want = matmul_ref(x, w)
        torch.cuda.synchronize()
        if matmul.launches != before + 1 or \
                matmul.wgmma_launches != before_wg + (path == "wgmma"):
            raise AssertionError(f"matmul {name}: kernel D's {path} path was not launched")
        mag = float(want.abs().max())
        err = max_abs_err(got, want)
        if got.shape != want.shape or got.dtype != dt or not torch.isfinite(got).all() \
                or err > MM_TOL[dtype] * mag:
            raise AssertionError(f"matmul {name}: kernel != plain (max abs err {err}, "
                                 f"tolerance {MM_TOL[dtype]} x {mag})")
        worst[dtype] = max(worst.get(dtype, 0.0), err / mag)
        log(f"matmul {name:>20} ({path}): max abs err {err:.3e} of {mag:.4g} (tolerance "
            f"{MM_TOL[dtype]} of it)")
        if name in ("mlp_up_bf16", "q_bf16", "mlp_down_bf16", "out_bf16"):
            out = torch.empty_like(got)
            flops = 2 * x.numel() * w.shape[-1]
            variant_ms = {k: time_ms(lambda: launch_matmul(x, w, out, persistent=p), reps=20)
                          for k, p in (("persistent", True), ("per_tile", False))}
            ms = time_ms(lambda: matmul(x, w), reps=20)
            ms_mma = time_ms(lambda: launch_matmul(x, w, out, path="mma_sync"), reps=20)
            lib_ms = time_ms(lambda: torch.matmul(x, w), reps=20)
            t_bound, by = _mm_bound(x, w, got)
            shapes_ms[name] = dict(ms=ms, ms_mma_sync=ms_mma, library_ms=lib_ms,
                                   bound_ms=t_bound, tflops=flops / ms / 1e9,
                                   wgmma_grid_ms=variant_ms)
            log(f"matmul {name} {list(x.shape)} @ {list(w.shape)} bf16: wgmma {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s), mma.sync {ms_mma:.4f} ms, torch.matmul "
                f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x its time), bound {t_bound:.4f} ms ({by}); "
                f"wgmma grids: " + ", ".join(f"{k} {v:.4f}" for k, v in variant_ms.items()))
            if name == "mlp_up_bf16":
                plain_ms = time_ms(lambda: matmul_ref(x, w), reps=5, warmup=1)
                row = dict(name="matmul", route="cuda", source="src/repro_torch/csrc/matmul.cu",
                           replaces="src/repro/kernels/matmul/kernel.py:38", launches=0,
                           max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t_bound,
                           bound_by=by, library_ms=lib_ms, path="wgmma", ms_before=ms_mma,
                           shape=[list(x.shape), list(w.shape)], dtype=dtype)
                log(f"matmul MLP-up plain version: {plain_ms:.4f} ms")
            del out
        del x, w, got, want
    row["max_rel_err_by_dtype"] = worst
    row["ring_step_shapes"] = shapes_ms
    row["host_us_per_call"] = _host_us_per_call(dev)
    return max(worst.values()), row


def _host_us_per_call(dev, n: int = 2000) -> dict:
    """Host microseconds a call of kernel D's entry point and of
    ``torch.matmul`` cost, on a product small enough that the device waits
    for the host (host clock over ``n`` calls ending in a synchronize): what
    each of the TP prefill's 1,280 launches costs the host."""
    import torch

    from repro_torch.kernels.matmul import matmul

    x = torch.ones((1, 128, 64), device=dev, dtype=torch.bfloat16)
    w = torch.ones((1, 64, 128), device=dev, dtype=torch.bfloat16)
    res = {}
    for name, fn in (("matmul", lambda: matmul(x, w)),
                     ("torch.matmul", lambda: torch.matmul(x, w))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        res[name] = (time.perf_counter() - t0) / n * 1e6
    log("host us per call at (1, 128, 64) @ (1, 64, 128) bf16: " +
        ", ".join(f"{k} {v:.2f}" for k, v in res.items()))
    return res


#: a layer's streamed calls in the TP prefill, by tag: the dense block (Q,
#: the K/V gather, the out-projection, gate and up, down), the Mamba2 block
#: (z and x, the B/C/dt gather, the out-projection), the MoE block (the
#: attention's three, the expert dispatch and combine) and the RG-LRU block
#: (branch and gate, the out-projection, then its SwiGLU MLP)
DENSE_CALLS = {"tp.attn.qkv": 1, "tp.attn.kv": 1, "tp.attn.out": 1, "tp.mlp.up": 2,
               "tp.mlp.down": 1}
GELU_CALLS = {**DENSE_CALLS, "tp.mlp.up": 1}
SSM_CALLS = {"ssm.in": 2, "ssm.gather": 1, "ssm.out": 1}
MOE_CALLS = {"tp.attn.qkv": 1, "tp.attn.kv": 1, "tp.attn.out": 1, "ep.dispatch": 1,
             "ep.combine": 1}
REC_CALLS = {"ssm.in": 2, "ssm.out": 1, "tp.mlp.up": 2, "tp.mlp.down": 1}
#: the streamed calls that run no product through kernel D, and the
#: reduce-scatters (each P - 1 gather-fused launches of A over smi:fused)
D_FREE_TAGS = ("tp.attn.kv", "ssm.gather", "ep.dispatch", "ep.combine")
RS_TAGS = ("tp.attn.out", "tp.mlp.down", "ssm.out", "ep.combine")


def _calls(cfg) -> dict:
    """A layer's streamed calls by tag for each block kind."""
    return {"attn": GELU_CALLS if cfg.mlp_type == "gelu" else DENSE_CALLS, "moe": MOE_CALLS,
            "ssm": SSM_CALLS, "rec": REC_CALLS}


def _call_counts(cfg) -> dict:
    """One TP prefill's streamed calls by tag, each layer's by its block
    kind (:func:`_calls`)."""
    calls, totals = _calls(cfg), {}
    for kind in cfg.layer_pattern:
        for t, n in calls[kind].items():
            totals[t] = totals.get(t, 0) + n
    return totals


def _tp_closed_form(cfg, P: int, tokens: int) -> dict:
    """Per tag, one rank's (steps, bytes) over one TP prefill of ``tokens``
    tokens: every streamed call moves P - 1 ring steps of one rank's rows
    (tokens / P) of the model width in the model dtype; each layer's calls
    by its block kind (:func:`_calls`), and the embedding's reduce-scatter
    (tp.embed) once.  E.g. yi-6b's tp.mlp.up = 2 x 7 x 512 x 4096 x 2 bytes
    a layer at P = 8."""
    step_bytes = (P - 1) * (tokens // P) * cfg.d_model * (2 if cfg.dtype == "bfloat16" else 4)
    want = {t: {"steps": (P - 1) * n, "bytes": step_bytes * n}
            for t, n in _call_counts(cfg).items()}
    want["tp.embed"] = {"steps": P - 1, "bytes": step_bytes}
    return want


def _d_launches(cfg, P: int) -> int:
    """Kernel D's launches in one TP prefill: P ring steps a projection."""
    return P * sum(n for t, n in _call_counts(cfg).items() if t not in D_FREE_TAGS)


def _rs_calls(cfg) -> int:
    """The reduce-scatters of one TP prefill: the embedding's and each
    row-parallel projection's."""
    return 1 + sum(n for t, n in _call_counts(cfg).items() if t in RS_TAGS)


def _profile_split(rows) -> dict:
    """Device ms by kind: kernel D, kernel E, cuBLAS GEMMs, sorting and
    scans (the MoE routing and dispatch), the ring's and the dispatch's
    index copies and fills, and the elementwise rest."""
    kinds = {"D": ("matmul_bf16_kernel", "matmul_wgmma_kernel"), "E": ("flash_attention",),
             "gemm": ("gemm", "nvjet", "xmma", "cutlass", "cublas"),
             "sort_scan": ("sort", "Sort", "scan", "Scan", "topk", "TopK", "radix", "bitonic"),
             "copies": ("index", "copy", "Copy", "gather", "scatter", "fill", "cat")}
    split = {k: 0.0 for k in (*kinds, "elementwise")}
    for name, ms in rows:
        kind = next((k for k, keys in kinds.items() if any(s in name for s in keys)),
                    "elementwise")
        split[kind] += ms
    return split


def phase_tp_prefill(dev, seed: int = 19) -> tuple[int, dict, object]:
    """yi-6b at full width and depth, P = 8 ranks over ``smi:static``,
    kernel D injected; see the module docstring (phase 19).  Returns D's
    launches, the results and the rank-stacked params (for phase 20)."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.interop import shard_params
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.steps import build_prefill
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import gather_hidden, init_lm, lm_prefill
    from repro_torch.models.model import model_dtype
    from repro_torch.parallel import ledger

    cfg = get_arch("yi-6b")
    shape = ShapeConfig("prefill_4k", PREFILL_TOKENS, 1, "prefill")
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                     dtype=model_dtype(cfg))
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                  (1, PREFILL_TOKENS))).to(dev)
    plain_step = build_prefill(cfg, shape, mesh=(1, TP), comm_mode="smi:static", device=dev)
    tp_params = shard_params(params, cfg, plain_step.ctx)
    torch.cuda.synchronize()
    log(f"tp prefill: {cfg.name} params drawn and split over {TP} ranks in "
        f"{time.perf_counter() - t0:.1f}s")
    ctx_d = make_ctx((1, TP), comm_mode="smi:static", matmul_fn=matmul, device=dev)

    def run_d():
        return gather_hidden(lm_prefill(tp_params, tokens, cfg, ctx_d,
                                        capacity=PREFILL_TOKENS))

    with ledger.capture() as led:
        run_d()  # warm-up, its wire traffic captured
    torch.cuda.synchronize()
    reset_counts()
    hidden, ms_d = _timed_ms(run_d)
    launches_d, launches_e = matmul.launches, flash_attention_kernel.launches
    wgmma_d, wgmma_e = matmul.wgmma_launches, flash_attention_kernel.wgmma_launches
    want_d = 5 * TP * cfg.n_layers
    if launches_d != want_d or launches_e != cfg.n_layers:
        raise AssertionError(f"TP prefill launched kernel D {launches_d} times (not {want_d}) "
                             f"and E {launches_e} times (not {cfg.n_layers})")
    if (wgmma_d, wgmma_e) != (launches_d, launches_e):
        raise AssertionError(f"TP prefill: {wgmma_d} of D's {launches_d} and {wgmma_e} of E's "
                             f"{launches_e} launches took the wgmma path")
    if tuple(hidden.shape) != (1, PREFILL_TOKENS, cfg.d_model) or not torch.isfinite(hidden).all():
        raise AssertionError(f"TP prefill hidden states {tuple(hidden.shape)} not finite or "
                             f"not (1, {PREFILL_TOKENS}, {cfg.d_model})")
    want_led = _tp_closed_form(cfg, TP, PREFILL_TOKENS)
    if led.by_tag != want_led:
        raise AssertionError(f"TP prefill ledger {led.by_tag} != closed form {want_led}")
    log(f"tp prefill ledger per tag equals the closed form: {json.dumps(led.tag_bytes())}")

    plain_step(tp_params, tokens)
    h_none, ms_none = _timed_ms(lambda: plain_step(tp_params, tokens))
    tp1 = build_prefill(cfg, shape, device=dev)
    tp1(params, tokens)
    h_tp1, ms_tp1 = _timed_ms(lambda: tp1(params, tokens))
    cos_none = float(_row_cos(hidden, h_none).min())
    cos_tp1 = float(_row_cos(hidden, h_tp1).min())
    cos_none_tp1 = float(_row_cos(h_none, h_tp1).min())
    log(f"tp prefill: D injected {ms_d:.3f} ms ({PREFILL_TOKENS / ms_d * 1e3:.1f} tok/s), "
        f"matmul_fn=None {ms_none:.3f} ms ({PREFILL_TOKENS / ms_none * 1e3:.1f} tok/s), "
        f"tp = 1 {ms_tp1:.3f} ms ({PREFILL_TOKENS / ms_tp1 * 1e3:.1f} tok/s); D launched "
        f"{launches_d} times ({wgmma_d} on wgmma), E {launches_e} ({wgmma_e} on wgmma)")
    log(f"tp prefill min row cosine: D vs matmul_fn=None {cos_none:.6f}, D vs tp = 1 "
        f"{cos_tp1:.6f} (matmul_fn=None vs tp = 1 {cos_none_tp1:.6f})")
    if min(cos_none, cos_tp1) < 0.999:
        raise AssertionError(f"TP prefill with D disagrees: min row cosine {cos_none} against "
                             f"matmul_fn=None, {cos_tp1} against tp = 1")
    del h_none, h_tp1, params, tp1
    torch.cuda.empty_cache()
    busy, rows, _ = _profile_device_ms(run_d)
    split = _profile_split(rows)
    log(f"tp prefill profiled device time {busy:.3f} ms: " + ", ".join(
        f"{k} {v:.3f} ms ({v / busy:.1%})" for k, v in split.items()))
    for name, t in rows[:12]:
        log(f"tp prefill profile: {t:9.3f} ms  {name[:90]}")
    res = dict(ms_d=ms_d, tok_per_s_d=PREFILL_TOKENS / ms_d * 1e3, ms_matmul_fn_none=ms_none,
               tok_per_s_matmul_fn_none=PREFILL_TOKENS / ms_none * 1e3, ms_tp1=ms_tp1,
               tok_per_s_tp1=PREFILL_TOKENS / ms_tp1 * 1e3, launches_d=launches_d,
               launches_e=launches_e, wgmma_launches_d=wgmma_d, wgmma_launches_e=wgmma_e,
               min_cos_vs_none=cos_none, min_cos_vs_tp1=cos_tp1,
               device_ms=busy, device_split_ms=split, ledger_bytes=led.tag_bytes())
    return launches_d, res, tp_params


def phase_tp_fused(dev, tp_params, n_layers: int = 4, seed: int = 20) -> dict:
    """Phase 19's prefill cut to ``n_layers`` layers over ``smi:fused``
    against ``smi:static``, both with D: bit for bit; kernel A's gather-fused
    form launched once per reduce-scatter ring step (the ledger's closed
    form), its plain add never.  Returns A's launches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.matmul import matmul
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import gather_hidden, lm_prefill
    from repro_torch.models.common import tree_map
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    cfg = get_arch("yi-6b").scaled(n_layers=n_layers)
    params = dict(tp_params, stack={"periods": tree_map(lambda t: t[:n_layers],
                                                        tp_params["stack"]["periods"]),
                                    "rem": tp_params["stack"]["rem"]})
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                  (1, PREFILL_TOKENS))).to(dev)
    out = {}
    for mode in ("smi:static", "smi:fused"):
        ctx = make_ctx((1, TP), comm_mode=mode, matmul_fn=matmul, device=dev)
        reset_counts()
        out[mode] = gather_hidden(lm_prefill(params, tokens, cfg, ctx, capacity=PREFILL_TOKENS))
        torch.cuda.synchronize()
        out[mode + ":A"] = (fused_shift_accumulate.launches, fused_accumulate.launches)
    if not same_bits(out["smi:fused"], out["smi:static"]):
        raise AssertionError(f"TP prefill over smi:fused differs from smi:static (max abs diff "
                             f"{max_abs_err(out['smi:fused'], out['smi:static'])})")
    # the reduce-scatters: the out-projection and MLP-down of every layer and
    # the embedding's, each P - 1 ring steps
    closed = _tp_closed_form(cfg, TP, PREFILL_TOKENS)
    ring_steps = sum(closed[t]["steps"] for t in ("tp.attn.out", "tp.mlp.down", "tp.embed"))
    shifts, folds = out["smi:fused:A"]
    if (shifts, folds) != (ring_steps, 0) or out["smi:static:A"] != (0, 0):
        raise AssertionError(f"kernel A launched {shifts} times gather-fused (not {ring_steps}) "
                             f"and {folds} as the plain add over smi:fused, "
                             f"{out['smi:static:A']} over smi:static")
    log(f"tp prefill {n_layers} layers: smi:fused bit-equal to smi:static, kernel A launched "
        f"{shifts} times gather-fused, once per reduce-scatter ring step")
    return {"shift": shifts, "fold": folds}


# -- slice 6: channels and the int8 wire (phases 21-24) ---------------------------------

#: the bandwidth phase's sizes per rank (KiB): the reference's three and 64 MiB,
#: where the 8 ranks hold 512 MiB, ten times the 50 MB L2
CHANNEL_BW_KIB = (16, 256, 4096, 65536)
#: GESUMMV: the sizes checked against the single-rank result, and the timed one
GESUMMV_CHECK_N = (1024, 2048)
GESUMMV_N = 16384
#: the compressed all-reduce held against the CPU on the same inputs, per rank
COMPRESSED_ELEMS = 1 << 20
POOL_TRANSFERS = 1000


def phase_channel_latency(dev) -> tuple[list[dict], dict]:
    """Phase 21 (paper Tab. 3): ``launch.channels.latency`` on an 8-rank bus
    at 1, 4 and 7 hops over static, fused and packet: a transfer of 8
    float32 at n_chunks=1 (checked) and a push/pop loop of 64 elements whose
    first element must arrive on the hops-th pop and whose destination must
    pop 64; µs per transfer and per pop.  Kernel C launches once per packet
    pop and transfer."""
    from repro_torch.kernels.router import router_run
    from repro_torch.launch.channels import _line, latency

    reset_counts()
    rows = latency(dev, count=64, reps=20)
    launches = {"C": router_run.launches, "C_warp": router_run.warp_launches}
    if launches["C"] == 0:
        raise AssertionError("the channel latency phase never launched kernel C")
    for row in rows:
        log(_line(row))
    log(f"channel latency: kernel C launched {launches['C']} times "
        f"({launches['C_warp']} on the warp path)")
    return rows, launches


def phase_channel_bandwidth(dev) -> tuple[list[dict], dict]:
    """Phase 22 (paper Fig. 9): ``launch.channels.bandwidth`` on the same bus
    at 16 KiB, 256 KiB, 4 MiB and 64 MiB per rank, 1, 4 and 7 hops,
    n_chunks=16, over static, fused, packet (to 4 MiB) and compressed:static
    beside the unpipelined ``staged_p2p``; every delivery checked; GB/s."""
    from repro_torch.kernels.router import router_run
    from repro_torch.launch.channels import _line, bandwidth

    reset_counts()
    rows = bandwidth(dev, sizes_kib=CHANNEL_BW_KIB, reps=5)
    launches = {"C": router_run.launches, "C_warp": router_run.warp_launches}
    if launches["C"] == 0:
        raise AssertionError("the channel bandwidth phase never launched kernel C")
    for row in rows:
        log(_line(row))
    log(f"channel bandwidth: kernel C launched {launches['C']} times "
        f"({launches['C_warp']} on the warp path)")
    return rows, launches


def phase_gesummv(dev) -> dict:
    """Phase 23 (paper §5.4.1, Fig. 13): GESUMMV on one rank and over two
    stacked ranks whose partial GEMVs meet through a channel; equal within
    2e-4 at N = 1024 and 2048 (the reference's gate); at N = 16384 in float32
    (1 GiB a matrix) both timed by CUDA events and by device time (the
    channel's eager host work shows in the first), GB/s beside the memory
    rate.
    Both ranks read one card's memory: no 2x is expected or claimed."""
    import torch

    from repro_torch.apps import gesummv, gesummv_two_ranks
    from repro_torch.core import Communicator

    comm = Communicator.create("x", (2,), device=dev)
    g = torch.Generator(device=dev).manual_seed(23)
    res = {}
    for N in (*GESUMMV_CHECK_N, GESUMMV_N):
        AB = torch.randn((2, N, N), generator=g, device=dev)
        x = torch.randn(N, generator=g, device=dev)
        one = gesummv(AB[0], AB[1], x)
        two = gesummv_two_ranks(AB, x, comm)
        torch.cuda.synchronize()
        scale = max(float(one.abs().max()), 1.0)
        err = float((two[1] - one).abs().max())
        if not (torch.isfinite(two).all() and err <= 2e-4 * scale and not two[0].any()):
            raise AssertionError(f"gesummv N={N}: two ranks off the single rank by {err}")
        row = {"max_abs_err": err, "scale": scale}
        if N == GESUMMV_N:
            nbytes = 2 * N * N * 4
            for name, fn in (("single", lambda: gesummv(AB[0], AB[1], x)),
                             ("two_ranks", lambda: gesummv_two_ranks(AB, x, comm))):
                ms, dev_ms = time_ms(fn, reps=10), device_ms(fn, reps=10)
                row[name] = {"ms": ms, "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
                             "device_ms": dev_ms, "device_gb_per_s": nbytes / (dev_ms * 1e-3) / 1e9}
            row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            for name, r in (("single rank", row["single"]),
                            ("two ranks over a channel", row["two_ranks"])):
                log(f"gesummv N={N} float32, {name}: {r['ms']:.4f} ms by CUDA events "
                    f"({r['gb_per_s']:.1f} GB/s), {r['device_ms']:.4f} ms of device time "
                    f"({r['device_gb_per_s']:.1f} GB/s); memory rate "
                    f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s, bound {row['bound_ms']:.4f} ms")
        else:
            log(f"gesummv N={N}: two ranks within {err:.3e} of the single rank (scale {scale:.1f})")
        res[N] = row
        del AB, x
    return res


def phase_collective_channels(dev) -> tuple[dict, dict]:
    """Phase 24: at 8 x 16 Mi float32 on ring(1x8) and torus(2x4), over
    smi:static and smi:fused, each of the five channel kinds' ``transfer``
    bit-equal to the direct collective; kernel A launched by the reduce
    channel's folds and the all-reduce's ring steps on smi:fused; the reduce
    and all-reduce channels timed beside the direct calls by device time in
    turns (direct, channel, channel, direct).  Then an all-reduce over
    compressed:static whose int8 wire and result are the CPU plain result's
    bits, and a ChannelPool spec serving 1,000 all-reduces on one claim."""
    import dataclasses

    import torch

    import repro_torch.channels as ch
    from repro_torch.core import Communicator
    from repro_torch.core import collectives as C
    from repro_torch.mesh.api import make_ctx
    from repro_torch.parallel import layers
    from repro_torch.transport.compressed import _pack_wire, _quantize_rows
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    g = torch.Generator(device=dev).manual_seed(24)
    x = torch.randn((P, REDUCE_ELEMS), generator=g, device=dev)
    xg = torch.randn((P, REDUCE_ELEMS // P), generator=g, device=dev)
    pairs = {
        "bcast": (lambda c, t: ch.open_bcast_channel(c, root=1, port=None,
                                                     transport=t).transfer(x),
                  lambda c, t: C._stream_bcast_impl(x, c, root=1, transport=t)),
        "reduce": (lambda c, t: ch.open_reduce_channel(c, root=3, port=None,
                                                       transport=t).transfer(x),
                   lambda c, t: C.reduce(x, c, root=3, plan=None, transport=t)),
        "gather": (lambda c, t: ch.open_gather_channel(c, root=0, port=None,
                                                       transport=t).transfer(xg),
                   lambda c, t: C._stream_gather_impl(xg, c, root=0, transport=t)),
        "scatter": (lambda c, t: ch.open_scatter_channel(c, root=0, port=None,
                                                         transport=t).transfer(x),
                    lambda c, t: C._stream_scatter_impl(x, c, root=0, transport=t)),
        "allreduce": (lambda c, t: ch.open_allreduce_channel(c, port=None,
                                                             transport=t).transfer(x),
                      lambda c, t: C.allreduce(x, c, plan=None, transport=t)),
    }
    reset_counts()
    res, launched = {"times": {}}, {"fold": 0, "shift": 0}
    for names, sizes in ((("x",), (8,)), (("x", "y"), DIMS)):
        comm = Communicator.create(names, sizes, device=dev)
        cname = "ring(1x8)" if len(sizes) == 1 else "torus(2x4)"
        for wire in ("static", "fused"):
            for kind, (chan, direct) in pairs.items():
                before = (fused_accumulate.launches, fused_shift_accumulate.launches)
                got = chan(comm, wire)
                after = (fused_accumulate.launches, fused_shift_accumulate.launches)
                want = direct(comm, wire)
                torch.cuda.synchronize()
                if not same_bits(got, want) or not torch.isfinite(got).all():
                    raise AssertionError(f"{kind} channel on {cname} over smi:{wire} differs "
                                         "from the direct call")
                launched["fold"] += after[0] - before[0]
                launched["shift"] += after[1] - before[1]
                del got, want
            log(f"collective channels on {cname} over smi:{wire}: all five bit-equal to the "
                f"direct calls")
        for kind in ("reduce", "allreduce"):
            chan, direct = pairs[kind]
            turns = {"direct": [], "channel": []}
            for who in ("direct", "channel", "channel", "direct"):
                fn = direct if who == "direct" else chan
                turns[who].append(device_ms(lambda: fn(comm, "fused"), reps=5, warmup=1))
            t = {k: sum(v) / len(v) for k, v in turns.items()}
            res["times"][f"{kind}/{cname}/fused"] = t | {"turns_ms": turns}
            log(f"{kind} on {cname} over smi:fused: channel {t['channel']:.4f} ms, direct "
                f"{t['direct']:.4f} ms of device time ({t['channel'] / t['direct'] - 1:+.2%})")
    counts = {"A_fold": fused_accumulate.launches, "A_shift": fused_shift_accumulate.launches}
    if launched["fold"] == 0 or launched["shift"] == 0:
        raise AssertionError(f"the collective channels launched kernel A {launched}")
    log(f"collective channels: kernel A launched {launched['fold']} times as the reduce "
        f"channels' plain add and {launched['shift']} times gather-fused by the all-reduce "
        f"channels (the checked transfers; {counts} with the timed ones)")
    del x, xg

    # the int8 wire: the card's codes, scales and all-reduce are the CPU's bits
    xc = torch.randn((P, COMPRESSED_ELEMS), generator=g, device=dev) * 10
    xh = xc.cpu()
    if not same_bits(_pack_wire(*_quantize_rows(xc, 256)).cpu(),
                     _pack_wire(*_quantize_rows(xh, 256))):
        raise AssertionError("the int8 wire's bits differ between the card and the CPU")
    card = ch.open_allreduce_channel(Communicator.create("x", (8,), device=dev), port=None,
                                     transport="compressed:static").transfer(xc)
    cpu = ch.open_allreduce_channel(Communicator.create("x", (8,), device="cpu"), port=None,
                                    transport="compressed:static").transfer(xh)
    if not same_bits(card.cpu(), cpu):
        raise AssertionError("the compressed all-reduce differs between the card and the CPU")
    err = float((card.double() - xc.double().sum(0)).abs().max())
    res["compressed"] = {"elems": COMPRESSED_ELEMS, "max_abs_err_vs_f32_sum": err}
    log(f"compressed:static all-reduce of 8 x {COMPRESSED_ELEMS} float32: the card's wire and "
        f"result equal the CPU's bit for bit; max abs err {err:.4f} against the exact sum")
    del xc, xh, card, cpu

    # the persistent pool: one claim serves every call
    ctx = make_ctx((1, P), comm_mode="smi:fused", device=dev)
    with ch.ChannelPool(ctx.model_comm) as pool:
        pctx = dataclasses.replace(ctx, channels=pool)
        xs = torch.randn((P, 4096), generator=g, device=dev)
        want = layers.all_reduce(xs, ctx)
        if not same_bits(layers.all_reduce(xs, pctx), want):
            raise AssertionError("an all-reduce through the pool differs")
        claims = [(r["port"], r["tag"], id(r["owner"])) for r in pool.claims()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(POOL_TRANSFERS):
            layers.all_reduce(xs, pctx)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) * 1e6 / POOL_TRANSFERS
        after = [(r["port"], r["tag"], id(r["owner"])) for r in pool.claims()]
        if after != claims or len(claims) != 1:
            raise AssertionError(f"the pool's claims moved: {claims} -> {after}")
    res["pool"] = {"transfers": POOL_TRANSFERS, "us_per_transfer": us, "claims": len(claims),
                   "port": claims[0][0], "tag": claims[0][1]}
    log(f"ChannelPool: {POOL_TRANSFERS} all-reduces of (8, 4096) float32 over smi:fused on one "
        f"claim (port {claims[0][0]}, {claims[0][1]}), {us:.1f} us each")
    return res, launched


# -- slice 7: netsim, the card's link model, the tuner (phases 25-27) -------------------

#: readings a calibration record's median is taken over (at least 9)
CALIBRATION_READINGS = 15


def unfused_add_latency(reduce_times: dict) -> float:
    """Phase 5's static-minus-fused device time of ``allreduce`` over its
    schedule's 2 (P - 1) ticks, seconds a tick, the mean over ring(1x8) and
    torus(2x4): what the static wire's separate add costs a reduction tick."""
    per_tick = [(t["device_static"] - t["device_fused"]) * 1e-3 / (2 * (P - 1))
                for k, t in reduce_times.items() if k.startswith("allreduce/")]
    return sum(per_tick) / len(per_tick)


def quant_latency(bandwidth_rows: list, link_bw: float) -> float:
    """Phase 22's ``compressed:static`` against ``static`` at equal size and
    hops, seconds a tick, the median over the sizes and hops: the model's
    compressed tick is ``hop_latency + quant_latency + wire_bytes(flit) /
    link_bw`` and its raw tick ``hop_latency + flit / link_bw``, so each
    pair gives ``(t_int8 - t_raw) / ticks + (flit - wire_bytes(flit)) /
    link_bw``, ``ticks = n_chunks + hops - 1``."""
    from repro_torch.netsim import LinkModel

    by = {(r["kib"], r["hops"], r["wire"]): r for r in bandwidth_rows}
    vals = []
    for (kib, hops, wire), r in by.items():
        raw = by.get((kib, hops, "static"))
        if wire != "compressed:static" or raw is None:
            continue
        ticks = r["n_chunks"] + hops - 1
        flit = kib * 1024 / r["n_chunks"]
        saved = (flit - LinkModel().wire_bytes(flit, "int8")) / link_bw
        vals.append((r["ms"] - raw["ms"]) * 1e-3 / ticks + saved)
    vals.sort()
    return vals[len(vals) // 2]


def switch_cycles(injection_rows: list) -> float:
    """Phase 9's ticks a packet at each R fitted to ``a + switch_cycles /
    R`` by least squares (``a`` takes the saturated link's contention, which
    R does not change; the model's ``injection_cycles(R) = 1 +
    switch_cycles / R`` keeps only the R-dependent part)."""
    import numpy as np

    R = np.array([r["R"] for r in injection_rows], float)
    c = np.array([r["ticks_per_packet"] for r in injection_rows], float)
    (_, s), *_ = np.linalg.lstsq(np.stack([np.ones_like(R), 1.0 / R], 1), c, rcond=None)
    return float(s)


def phase_link_fit(dev, reduce_times: dict, injection: list, bandwidth_rows: list) -> dict:
    """Phase 25: the reference's ``benchmarks/{latency,bandwidth}.py
    --validate-sim`` on the port (``launch.channels.validate_sim``): the
    static wire's Tab. 3 and Fig. 9 transfers on the 8-rank bus as
    calibration records, each set fitted and gated at 2x; the fit of both
    sets, with the three parameters ``fit`` leaves alone from phases 5, 22
    and 9, is the card's link model.  Prints it, and the worst drift of the
    committed default model on this run's records (a reading, not a gate)."""
    from repro_torch.launch.channels import validate_sim
    from repro_torch.netsim import LinkModel
    from repro_torch.netsim.calibrate import drift_ratio

    fitted, lat, bw = validate_sim(dev, CHANNEL_BW_KIB, reps=CALIBRATION_READINGS)
    model = fitted.with_params(unfused_add_latency=unfused_add_latency(reduce_times),
                               quant_latency=quant_latency(bandwidth_rows, fitted.link_bw),
                               switch_cycles=switch_cycles(injection))
    recs = lat + bw
    worst = {name: max(drift_ratio(m.predict(r), r["seconds"]) for r in recs)
             for name, m in (("fitted", model), ("committed_default", LinkModel()))}
    log(f"link model fitted on this card: {model!r}")
    log(f"worst drift on this run's {len(recs)} records: the fit of both sets "
        f"{worst['fitted']:.3f}x, the committed default {worst['committed_default']:.3f}x")
    return {"model": {k: getattr(model, k) for k in (
        "hop_latency", "link_bw", "injection_base", "switch_cycles", "quant_latency",
        "unfused_add_latency")}, "worst_drift": worst,
        "records": [{k: r[k] for k in ("name", "steps", "bytes", "seconds")} for r in recs]}


#: phase 26's rank layouts: (axis names, axis sizes, bus?)
AUTO_LAYOUTS = {"ring(1x8)": (("x",), (8,), False), "torus(2x4)": (("x", "y"), DIMS, False),
                "bus(8)": (("x",), (8,), True)}
#: phase 26's message sizes, float32 elements a rank: 4 KiB, 256 KiB, 16 MiB
AUTO_ELEMS = (1024, 64 * 1024, 4 * 1024 * 1024)
AUTO_STENCIL_ARGS = ["--grid", "2x4", "--domain", "8192x8192", "--steps", "8", "--plan", "auto"]


def _codec_bound(x, hops_quantised: int) -> float:
    """The int8 wire's bound (tests/test_torch_compressed.py): ``hops``
    roundings of data bounded by max|x|, half a step of max|x| / 127 each."""
    return hops_quantised * float(x.abs().max()) / 254.0 * 1.05 + 1e-6


def _table_lines(table) -> list[str]:
    lines = []
    for op in sorted({o for o, _ in table.entries}):
        cells = []
        for (o, size), e in sorted(table.entries.items()):
            if o == op:
                tag = "" if e["wire"] == "raw" else ":int8"
                cells.append(f"{size >> 10}K {e['transport']}/{e['algo']}/{e['n_chunks']}{tag} "
                             f"x{e['static_score'] / e['score']:.2f}")
        lines.append(f"{op}: " + ", ".join(cells))
    return lines


def phase_tuned_collectives(dev) -> tuple[dict, dict]:
    """Phase 26: on ring(1x8), torus(2x4) and the bus(8), each topology's
    ``autotune`` seconds and table (plans, the tuner's predicted speed-up
    over the static default); ``bcast``, ``reduce`` and ``allreduce`` at
    one rank's 4 KiB, 256 KiB and 16 MiB of float32 with ``plan="auto"``
    against ``plan=None``, checked (bcast bit for bit; reduce and allreduce
    on a raw plan within 1e-6 of the largest magnitude, bit for bit where the
    tuned algorithm is the default's; an int8 plan within the codec's bound)
    and timed in turns (auto, then default) by CUDA events and device
    time beside the tuner's predicted ratio.  Then ``launch.stencil
    --plan auto`` at 8192x8192 on the 2x4 grid, equal to the single-rank
    sweep bit for bit, kernel B launched.  Returns the results and the
    kernel launches of the checked runs."""
    import torch

    from repro_torch.core import Communicator, Topology
    from repro_torch.core import collectives as C
    from repro_torch.kernels.stencil import stencil_sweep
    from repro_torch.launch import stencil as launch_stencil
    from repro_torch.netsim import DEFAULT_PLAN, tune
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    log("phase 26 runs plan='auto' on purpose: the collectives' default and the halo's")
    g = torch.Generator(device=dev).manual_seed(26)
    res = {"autotune_s": {}, "plans": {}, "ops": {}}
    launched = {"A_fold": 0, "A_shift": 0, "B": 0}
    calls = {"bcast": lambda x, c, **k: C.bcast(x, c, root=0, **k),
             "reduce": lambda x, c, **k: C.reduce(x, c, root=0, **k),
             "allreduce": lambda x, c, **k: C.allreduce(x, c, **k)}
    for lname, (names, sizes, bus) in AUTO_LAYOUTS.items():
        comm = Communicator.create(names, sizes, topology=Topology.bus(8) if bus else None,
                                   device=dev)
        tune.clear_cache()  # time the table's build
        t0 = time.perf_counter()
        table = tune.tuning_table_for(comm.topology, comm.route_table)
        res["autotune_s"][lname] = time.perf_counter() - t0
        log(f"autotune {lname}: {res['autotune_s'][lname]:.3f}s, model {table.model!r}")
        for line in _table_lines(table):
            log(f"  table {lname} {line}")
        for elems in AUTO_ELEMS:
            x = torch.randn((P, elems), generator=g, device=dev)
            for op, call in calls.items():
                plan = comm.plan(op, elems * 4)
                key = f"{op}/{lname}/{elems * 4 >> 10}KiB"
                res["plans"][key] = plan.to_dict()
                before = (fused_accumulate.launches, fused_shift_accumulate.launches)
                got = call(x, comm, plan="auto")
                torch.cuda.synchronize()
                launched["A_fold"] += fused_accumulate.launches - before[0]
                launched["A_shift"] += fused_shift_accumulate.launches - before[1]
                want = call(x, comm, plan=None)
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{key}: tuned result not finite ({plan})")
                err = max_abs_err(got, want)
                if plan.wire == "int8":
                    bound = _codec_bound(x, 1 if op == "bcast" else P)
                    bound += 0.0 if op == "bcast" else _codec_bound(want, 1)
                    gate = f"int8 within {bound:.4g}"
                    ok = err <= bound
                elif op == "bcast" or plan.algo == "ring":
                    gate, ok = "bit-equal", same_bits(got, want)
                else:
                    bound = 1e-6 * float(want.abs().max())
                    gate, ok = f"within {bound:.3g} (1e-6 of max)", err <= bound
                if not ok:
                    raise AssertionError(f"{key}: plan {plan} off the default by {err} ({gate})")
                del got, want
                reps, dreps = (5, 3) if elems >= AUTO_ELEMS[-1] else (20, 10)
                ms, dev_ms = {"auto": [], "default": []}, {"auto": [], "default": []}
                for who in ("auto", "default"):
                    kw = {"plan": "auto" if who == "auto" else None}
                    ms[who].append(time_ms(lambda: call(x, comm, **kw), reps=reps, warmup=2))
                    dev_ms[who].append(device_ms(lambda: call(x, comm, **kw), reps=dreps,
                                                 warmup=1))
                t = {k: sum(v) / len(v) for k, v in ms.items()}
                d = {k: sum(v) / len(v) for k, v in dev_ms.items()}
                predicted = (tune.score_plan(comm.topology, comm.route_table, op, elems * 4,
                                             DEFAULT_PLAN, table.model)
                             / tune.score_plan(comm.topology, comm.route_table, op, elems * 4,
                                               plan, table.model))
                res["ops"][key] = {"plan": plan.to_dict(), "gate": gate, "max_abs_err": err,
                                   "ms": t, "device_ms": d, "turns_ms": ms,
                                   "predicted_speedup": predicted,
                                   "measured_speedup": t["default"] / t["auto"],
                                   "measured_device_speedup": d["default"] / d["auto"]}
                tag = "" if plan.wire == "raw" else ":int8"
                log(f"{key:>28}: {plan.transport}/{plan.algo}/{plan.n_chunks}{tag} {gate}; auto "
                    f"{t['auto']:.4f} ms, default {t['default']:.4f} ms (x{t['default'] / t['auto']:.2f}"
                    f"; device {d['auto']:.4f} / {d['default']:.4f} ms, "
                    f"x{d['default'] / d['auto']:.2f}); tuner predicted x{predicted:.2f}")
            del x
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "auto.json")
        before = stencil_sweep.launches
        rc = launch_stencil.main([*AUTO_STENCIL_ARGS, "--json", out])
        torch.cuda.synchronize()
        launched["B"] = stencil_sweep.launches - before
        st = json.loads(Path(out).read_text())
    if rc != 0 or not st["ok"] or st["max_err"] != 0.0 or launched["B"] == 0:
        raise AssertionError(f"stencil --plan auto: rc={rc} result={st}, kernel B launched "
                             f"{launched['B']} times")
    res["stencil"] = st
    log(f"stencil --plan auto ({st['comm_mode']}): halo backend {st['halo_backend']}, "
        f"{st['wall_per_step_s'] * 1e3:.4f} ms/step, halo {st['halo_steps']} steps / "
        f"{st['halo_bytes_per_rank']} B per rank, equal to the single-rank sweep; kernel B "
        f"launched {launched['B']} times")
    return res, launched


def _int8_layer_checks(dev, ctx, plans: dict) -> dict:
    """Each tag the tuner put on the int8 wire, held alone to the wire's
    bound: its collective on a (P, 512, 4096) bfloat16 activation over the
    tuned key against the raw wire (a gather: one int8 rounding; a
    reduce-scatter: P, and the result's), plus the bfloat16 roundings of
    the values (one a gathered value, one an add of the P-term sum, each
    half an ulp, 2^-9 of the largest magnitude, counted as 2^-8)."""
    import torch

    from repro_torch.parallel import layers

    g = torch.Generator(device=dev).manual_seed(27)
    x = torch.randn((TP, PREFILL_TOKENS // TP, 4096), generator=g, device=dev,
                    dtype=torch.bfloat16)
    out = {}
    for tag, key in plans.items():
        if not key.startswith("compressed"):
            continue
        if tag in ("tp.attn.out", "tp.mlp.down", "tp.embed"):
            xs = torch.cat([x] * TP, dim=1)
            raw = layers.reduce_scatter_sequence(xs, ctx, tag="probe", transport="static")
            got = layers.reduce_scatter_sequence(xs, ctx, tag="probe", transport=key)
            bound = (_codec_bound(xs.float(), TP) + _codec_bound(raw.float(), 1)
                     + TP * float(raw.float().abs().max()) * 2 ** -8)
        else:
            raw = layers.gather_sequence(x, ctx, tag="probe", transport="static")
            got = layers.gather_sequence(x, ctx, tag="probe", transport=key)
            bound = _codec_bound(x.float(), 1) + float(x.float().abs().max()) * 2 ** -8
        err = max_abs_err(got, raw)
        if err > bound:
            raise AssertionError(f"{tag} over {key}: off the raw wire by {err} > {bound}")
        out[tag] = {"max_abs_err": err, "bound": bound}
        log(f"tp auto: {tag} over {key} within the int8 bound ({err:.4g} <= {bound:.4g})")
    return out


def phase_tp_auto(dev, tp_params, seed: int = 19) -> dict:
    """Phase 27: yi-6b at full width and depth, P = 8, 4096 tokens, through
    ``build_prefill``'s default launch (bare ``"smi"``: the config's
    ``comm_plan="auto"``) with kernel D injected: ``make_ctx((1, 8),
    comm_mode="smi", plan="auto", matmul_fn=matmul)``.  Gates: a registry
    key recorded for every TP layer tag; every D and E launch on ``wgmma``;
    the ledger equal to phase 19's closed form for each tag on ``static`` or
    ``fused``; finite hidden states within a row cosine of 0.999 of phase
    19's ``smi:static`` prefill (run again here, in turns with the tuned one)
    when every plan is raw, else the int8 tags held alone to the wire's
    bound.  ms and tokens/s of both."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul import matmul
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import gather_hidden, lm_prefill
    from repro_torch.parallel import ledger
    from repro_torch.transport import is_transport_key

    cfg = get_arch("yi-6b")
    log(f"phase 27 runs plan={cfg.comm_plan!r} on purpose: the config's comm_plan under a "
        "bare comm_mode='smi'")
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                  (1, PREFILL_TOKENS))).to(dev)
    ctxs = {"auto": make_ctx((1, TP), comm_mode="smi", plan=cfg.comm_plan, matmul_fn=matmul,
                             device=dev),
            "static": make_ctx((1, TP), comm_mode="smi:static", matmul_fn=matmul, device=dev)}

    def run(ctx):
        return gather_hidden(lm_prefill(tp_params, tokens, cfg, ctx, capacity=PREFILL_TOKENS))

    with ledger.capture() as led:
        run(ctxs["auto"])  # warm-up, its wire traffic and plans captured
    torch.cuda.synchronize()
    reset_counts()
    hidden = run(ctxs["auto"])
    torch.cuda.synchronize()
    launches = {"D": matmul.launches, "D_wgmma": matmul.wgmma_launches,
                "E": flash_attention_kernel.launches,
                "E_wgmma": flash_attention_kernel.wgmma_launches}
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    launches |= {"A_fold": fused_accumulate.launches, "A_shift": fused_shift_accumulate.launches}
    if launches["D"] != 5 * TP * cfg.n_layers or launches["E"] != cfg.n_layers or \
            launches["D_wgmma"] != launches["D"] or launches["E_wgmma"] != launches["E"]:
        raise AssertionError(f"tp auto prefill launches {launches}")
    if set(led.plans) != set(led.by_tag) or not all(is_transport_key(k)
                                                    for k in led.plans.values()):
        raise AssertionError(f"tp auto prefill: plans {led.plans} for tags {sorted(led.by_tag)}")
    closed = _tp_closed_form(cfg, TP, PREFILL_TOKENS)
    exact = {t for t, k in led.plans.items() if k in ("static", "fused")}
    for tag in sorted(led.by_tag):
        if tag in exact and led.by_tag[tag] != closed[tag]:
            raise AssertionError(f"tp auto prefill ledger {tag}: {led.by_tag[tag]} != closed "
                                 f"form {closed[tag]}")
        if tag not in exact:
            log(f"tp auto prefill: {tag} over {led.plans[tag]}: {led.by_tag[tag]['steps']} steps, "
                f"{led.by_tag[tag]['bytes']} B per rank (not a raw wire)")
    log(f"tp auto prefill plans: {json.dumps(led.plans)}; the ledger equals the closed form on "
        f"{len(exact)} of {len(led.plans)} tags")
    if tuple(hidden.shape) != (1, PREFILL_TOKENS, cfg.d_model) or not torch.isfinite(hidden).all():
        raise AssertionError("tp auto prefill hidden states not finite or misshapen")
    ms = {"auto": [], "static": []}
    outs = {}
    for who in ("static", "auto", "auto", "static"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs[who] = run(ctxs[who])
        torch.cuda.synchronize()
        ms[who].append((time.perf_counter() - t) * 1e3)
    cos = float(_row_cos(hidden, outs["static"]).min())
    if not same_bits(outs["auto"], hidden):
        raise AssertionError("tp auto prefill is not deterministic from run to run")
    int8 = {}
    if any(k.startswith("compressed") for k in led.plans.values()):
        log(f"tp auto prefill: an int8 plan; end-to-end min row cosine {cos:.6f}")
        int8 = _int8_layer_checks(dev, ctxs["auto"], led.plans)
    elif cos < 0.999:
        raise AssertionError(f"tp auto prefill: min row cosine {cos} against smi:static")
    t = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"tp auto prefill: {t['auto']:.3f} ms ({PREFILL_TOKENS / t['auto'] * 1e3:.1f} tok/s) "
        f"against smi:static {t['static']:.3f} ms ({PREFILL_TOKENS / t['static'] * 1e3:.1f} "
        f"tok/s), turns {json.dumps(ms)}; min row cosine {cos:.6f}; launches {launches}")
    return {"plans": led.plans, "ms": t, "turns_ms": ms,
            "tok_per_s": {k: PREFILL_TOKENS / v * 1e3 for k, v in t.items()},
            "min_cos_vs_static": cos, "launches": launches, "int8_layers": int8,
            "ledger_bytes": led.tag_bytes()}


# -- slice 8: tensor-parallel decode and serving (phases 28-30) -------------------------

#: the launcher runs at P = 8 (phases 28, 32, 35 and 39-41): phase 14's
#: request set on the pinned static wire and on the bare "smi" (the
#: config's comm_plan="auto"), tokens equal across the two
TP_SERVE_WIRES = ("smi:static", "smi")
#: phase 28's in-process checks: decode steps compared, ticks timed a turn
#: (6 before the planning phases 56-58 needed the time)
TP_DECODE_STEPS = 4
TP_TICKS = 2
#: phase 28's float32 copy at full width: its depth, and the reference's own
#: tolerance for a parallel decode against a single-device one
#: (tests/test_model_parallel.py::test_parallel_decode_matches_single)
TP_F32_LAYERS = 4
TP_F32_TOL = 3e-4


def f32_excess(got, want) -> float:
    """How far ``got`` lies beyond :data:`TP_F32_TOL` rtol and atol of
    ``want`` at its worst element (within it: <= 0; NaN: inf)."""
    ex = float(((got - want).abs() - (TP_F32_TOL + TP_F32_TOL * want.abs())).max())
    return ex if ex == ex else float("inf")
#: phase 29's meshes and wires
VALIDATE_MESHES = ("1,8", "2,4")
VALIDATE_WIRES = ("smi:static", "smi:fused")


def _a_launches() -> dict:
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    return {"shift": fused_shift_accumulate.launches, "fold": fused_accumulate.launches}


#: the serving launcher runs cut in depth (``--layers``) to keep the script
#: inside its time limit: decode is host-bound, so a run's time goes with
#: its layers (halved again with the tooling's phases 53-55, when a whole
#: run at the earlier depths took 1261.6 s on a slow host, and yi-6b's,
#: qwen3-moe's and musicgen's once more with the planning phases 56-58,
#: and all but yi-6b's once more with the rank processes of phase 59)
SERVE_LAYERS = {"yi-6b": 4, "mamba2-2.7b": 8, "qwen3-moe-30b-a3b": 4,
                "recurrentgemma-9b": 5, "internvl2-1b": 4, "musicgen-medium": 4}


def _launcher_runs(arch: str, mesh: str, wires, extra=()) -> tuple[dict, dict]:
    """``launch.serve --arch arch --mesh mesh`` with phase 14's requests,
    wave then continuous, on each of ``wires``, at :data:`SERVE_LAYERS`'s
    depth where it names the arch; kernel A's launches counted per run.
    Every request's tokens must be equal across the runs."""
    import torch

    from repro_torch.launch import serve as launch_serve

    results, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for wire in wires:
            for engine in ("wave", "continuous"):
                out = os.path.join(tmp, f"{engine}.json")
                reset_counts()
                depth = ["--layers", str(SERVE_LAYERS[arch])] if arch in SERVE_LAYERS else []
                rc = launch_serve.main(["--arch", arch, *SERVE_ARGS, *depth, "--mesh", mesh,
                                        "--comm-mode", wire, "--engine", engine, *extra,
                                        "--json", out])
                torch.cuda.synchronize()
                launches[f"{wire} {engine}"] = _a_launches()
                gc.collect()  # the run's weights go before the next run draws its own
                torch.cuda.empty_cache()
                res = json.loads(Path(out).read_text())
                if rc != 0 or res["completed"] != res["requests"]:
                    raise AssertionError(f"serve {arch} mesh {mesh} {wire} {engine}: rc={rc}, "
                                         f"{res['completed']} of {res['requests']} requests "
                                         f"completed")
                results[f"{wire} {engine}"] = res
                log(f"serve {arch} mesh {mesh} {wire} {engine}: {res['tokens']} tokens in "
                    f"{res['seconds']:.3f}s ({res['tok_per_s']:.1f} tok/s), "
                    f"{res['decode_steps']} decode steps ({res['ms_per_step']:.3f} ms/step); "
                    f"kernel A {launches[f'{wire} {engine}']}")
    outs = {k: v["out"] for k, v in results.items()}
    first = next(iter(outs.values()))
    if any(o != first for o in outs.values()):
        raise AssertionError(f"serve {arch} mesh {mesh}: the engines or wires emitted different "
                             f"tokens: {outs}")
    log(f"serve {arch} mesh {mesh}: tokens equal across {len(outs)} runs (2 engines x "
        f"{len(wires)} wires) for all {len(first)} requests")
    return results, launches


def _brief(runs: dict) -> dict:
    """A launcher run's rates and counts, by run."""
    return {k: {m: v[m] for m in ("tok_per_s", "ms_per_step", "decode_steps", "tokens")}
            for k, v in runs.items()}


def _serve_tokens(runs: dict) -> dict:
    """Every request's tokens (equal across ``runs``: :func:`_launcher_runs`)."""
    return next(iter(runs.values()))["out"]


def _tp_serve_runs() -> tuple[dict, dict]:
    """Phase 28's launcher runs: yi-6b at ``1,8`` on each of
    :data:`TP_SERVE_WIRES`."""
    return _launcher_runs("yi-6b", f"1,{TP}", TP_SERVE_WIRES)


def _a_per_step(runs: dict, launches: dict) -> dict:
    """Kernel A's launches a decode step over the P = 8 launcher runs on the
    bare ``smi`` (the tuned plans), by entry point; A must launch on that
    wire and never on ``smi:static`` (whose add is A's plain version)."""
    if any(v["shift"] + v["fold"] for k, v in launches.items() if k.startswith("smi:static")):
        raise AssertionError(f"tp serve on smi:static launched kernel A: {launches}")
    keys = [k for k in launches if k.split()[0] == "smi"]
    steps = sum(runs[k]["decode_steps"] for k in keys)
    per_step = {e: sum(launches[k][e] for k in keys) / max(steps, 1) for e in ("shift", "fold")}
    if sum(per_step.values()) == 0:
        raise AssertionError(f"tp serve on the tuned wire launched kernel A no time: {launches}")
    return per_step


def _decode_turns(dev, cfg, params, tp_params, n: int = TP_TICKS) -> dict:
    """ms a decode step at P = 8 (``smi:static``, a continuous engine of 4
    slots and 256 positions) beside tp = 1 on the same weights, in turns
    (tp = 1, P, P, tp = 1), ``n`` ticks a turn; then ``n`` P = 8 ticks'
    device time by kernel and the device's idle share under
    ``torch.profiler``."""
    from repro_torch.launch.steps import build_continuous_serve

    eng8 = _busy_engine(cfg, tp_params, build_continuous_serve(
        cfg, mesh=(1, TP), comm_mode="smi:static", batch_slots=4, capacity=256, device=dev), n)
    eng1 = _busy_engine(cfg, params, n_ticks=n)
    turns = {"tp1": [], f"tp{TP}": []}
    for who, eng in (("tp1", eng1), (f"tp{TP}", eng8), (f"tp{TP}", eng8), ("tp1", eng1)):
        turns[who].append(_engine_ticks_ms(eng, n))
    ms = {k: sum(v) / len(v) for k, v in turns.items()}
    busy, rows, wall = _profile_device_ms(lambda: [eng8.tick() for _ in range(n)])
    eng8.shutdown()
    log(f"{cfg.name} decode ms/step (4 slots, 256 positions, smi:static): P={TP} "
        f"{ms[f'tp{TP}']:.3f}, tp = 1 {ms['tp1']:.3f}; turns {json.dumps(turns)}")
    log(f"{cfg.name} tp decode profile: device {busy / n:.3f} ms of {wall / n:.3f} "
        f"ms wall a step (idle {max(0.0, 1 - busy / wall):.1%})")
    for name, t in rows[:8]:
        log(f"{cfg.name} tp decode profile: {t / n:8.3f} ms/step  {name[:90]}")
    return {"ms_per_step": ms, "turns_ms": turns, "device_ms_per_step": busy / n,
            "wall_ms_per_step_profiled": wall / n, "idle": max(0.0, 1 - busy / wall),
            "top_kernels_ms_per_step": [(name[:60], t / n) for name, t in rows[:8]]}


def _engine_ticks_ms(eng, n: int) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        eng.tick()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / n


def _busy_engine(cfg, params, runtime=None, n_ticks: int = TP_TICKS):
    """A continuous engine (4 slots, 256 positions) whose slots stay busy
    for the warm-up and ``3 * n_ticks`` timed ticks (a codebook model's
    prompt tokens repeated over its codebooks)."""
    from repro_torch.serving import ContinuousEngine, Request

    eng = (ContinuousEngine(cfg, params, runtime=runtime) if runtime is not None else
           ContinuousEngine(cfg, params, batch_slots=4, capacity=256))
    for uid in range(4):
        prompt = [1 + uid, 2, 3]
        if cfg.n_codebooks > 1:
            prompt = [[t] * cfg.n_codebooks for t in prompt]
        eng.submit(Request(uid=uid, prompt=prompt, max_new=8 * n_ticks))
    for _ in range(2):
        eng.tick()
    return eng


def _fused_against_static(cfg, tp_params, dev, rng) -> dict:
    """Kernel A on the TP decode path: the first :data:`TP_DECODE_STEPS`
    decode steps of a pinned ``smi:fused`` runtime and of an ``smi:static``
    one, on the same params, fresh caches and the same tokens, give the same
    logits bit for bit, with A's launches rising on every fused step and
    never on a static one (the static wire's add is A's plain version).
    Every ``(x, addend, src)`` the fused decode's ring steps handed A in the
    first step is then run again through A and its plain version, bit for
    bit; their shapes are returned."""
    import numpy as np
    import torch

    from repro_torch.launch.steps import build_continuous_serve
    from repro_torch.serving.engine import token_shape
    from repro_torch.transport.fused import (
        FusedTransport,
        fused_shift_accumulate,
        shift_accumulate_plain,
        source_index,
    )

    rts = {w: build_continuous_serve(cfg, mesh=(1, TP), comm_mode=w, batch_slots=4,
                                     capacity=256, device=dev)
           for w in ("smi:static", "smi:fused")}
    caches = {w: rt["init_caches"]() for w, rt in rts.items()}
    seen, launches = [], []
    method = FusedTransport.shift_accumulate

    def recording(self, x, addend, comm, step=1):
        if record:
            seen.append((x.clone(), addend.clone(),
                         source_index(tuple(comm.ring_perm(step)), x.shape[0], x.device)))
        return method(self, x, addend, comm, step)

    FusedTransport.shift_accumulate = recording
    try:
        for t in range(TP_DECODE_STEPS):
            record = t == 0
            tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, token_shape(cfg, 4))
                                   .astype(np.int32)).to(dev)
            pos = torch.full((4,), t, dtype=torch.int32, device=dev)
            a0 = _a_launches()
            want, _ = rts["smi:static"]["step"](tp_params, caches["smi:static"], tok, pos)
            torch.cuda.synchronize()
            if _a_launches() != a0:
                raise AssertionError(f"tp decode step {t}: smi:static launched kernel A "
                                     f"({a0} -> {_a_launches()})")
            before = fused_shift_accumulate.launches
            got, _ = rts["smi:fused"]["step"](tp_params, caches["smi:fused"], tok, pos)
            torch.cuda.synchronize()
            launches.append(fused_shift_accumulate.launches - before)
            if not same_bits(got, want) or launches[-1] == 0:
                raise AssertionError(f"tp decode step {t}: smi:fused against smi:static: same "
                                     f"bits {same_bits(got, want)}, kernel A launches "
                                     f"{launches[-1]} (max abs err {max_abs_err(got, want)})")
    finally:
        FusedTransport.shift_accumulate = method
    for rt in rts.values():
        rt["pool"].close()
    del caches
    shapes = sorted({(tuple(x.shape), str(x.dtype)) for x, _, _ in seen})
    for x, addend, src in seen:
        got = fused_shift_accumulate(x, addend, src)
        want = shift_accumulate_plain(x, addend, src)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"shift_accumulate at the TP decode's {tuple(x.shape)} "
                                 f"{x.dtype}: kernel != plain (max abs err "
                                 f"{max_abs_err(got, want)})")
    log(f"tp decode smi:fused: logits bit-equal to smi:static over {TP_DECODE_STEPS} steps, "
        f"kernel A launched {launches} times a step; its {len(seen)} calls of the first step "
        f"at {shapes} bit-equal to the plain version")
    return {"steps": TP_DECODE_STEPS, "a_launches_per_step": launches,
            "a_operands_checked": len(seen), "a_shapes": shapes}


def phase_tp_serving(dev, seed: int = 28) -> dict:
    """Phase 28: yi-6b at full width and depth served at P = 8; see the
    module docstring.  Returns the results and kernel A's launches per
    decode step on the tuned wire."""
    import numpy as np
    import torch

    from repro_torch.channels import PORTS
    from repro_torch.configs import get_arch
    from repro_torch.interop import shard_params
    from repro_torch.launch.steps import build_continuous_serve
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import init_lm, lm_caches, lm_decode_step
    from repro_torch.models.model import model_dtype
    from repro_torch.parallel import ledger
    from repro_torch.serving import ContinuousEngine, Request

    runs, launches = _tp_serve_runs()
    a_per_step_runs = _a_per_step(runs, launches)

    cfg = get_arch("yi-6b")
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                     dtype=model_dtype(cfg))
    rt = build_continuous_serve(cfg, mesh=(1, TP), comm_mode="smi", batch_slots=4,
                                capacity=256, device=dev)
    tp_params = shard_params(params, cfg, rt["ctx"])
    torch.cuda.synchronize()
    log(f"tp serve: {cfg.name} params drawn and split over {TP} ranks in "
        f"{time.perf_counter() - t0:.1f}s")

    # the tuned wire's plans at the decode's bytes, and the first steps' logits
    # against the tp = 1 step on the same tokens and weights
    ctx1 = make_ctx()
    caches1, caches8 = lm_caches(cfg, 4, 256, ctx1, dev), rt["init_caches"]()
    rng = np.random.RandomState(seed)
    cos, plans = [], None
    reset_counts()
    for t in range(TP_DECODE_STEPS):
        tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (4,)).astype(np.int32)).to(dev)
        pos = torch.full((4,), t, dtype=torch.int32, device=dev)
        want, _ = lm_decode_step(params, caches1, tok, pos, cfg, ctx1)
        with ledger.capture() as led:
            got, _ = rt["step"](tp_params, caches8, tok, pos)
        plans = plans or dict(led.plans)
        if not torch.isfinite(got).all() or tuple(got.shape) != tuple(want.shape):
            raise AssertionError(f"tp decode step {t}: logits {tuple(got.shape)} not finite")
        cos.append(float(torch.nn.functional.cosine_similarity(got, want, dim=-1).min()))
    a_per_step = {k: v / max(TP_DECODE_STEPS, 1) for k, v in _a_launches().items()}
    log(f"tp decode: tuned plans at the decode's bytes {json.dumps(plans)}; min row cosine of "
        f"the logits against tp = 1, step by step: {[round(c, 6) for c in cos]}")
    if min(cos) < 0.999:
        raise AssertionError(f"tp decode logits disagree with tp = 1: min row cosine {min(cos)}")
    del caches1, caches8
    rt["pool"].close()
    fused_check = _fused_against_static(cfg, tp_params, dev, rng)

    # one migration with decode ticks in flight, over the pool's channels
    def serve(migrate: bool):
        rts = build_continuous_serve(cfg, mesh=(1, TP), comm_mode="smi:static", batch_slots=4,
                                     capacity=256, device=dev)
        eng = ContinuousEngine(cfg, tp_params, runtime=rts)
        for uid, p in enumerate(([11, 12, 13], [21, 22], [31, 32, 33, 34])):
            eng.submit(Request(uid=uid, prompt=p, max_new=8))
        done = eng.tick() + eng.tick()
        ports = eng.pool.ports()
        if migrate:
            eng.migrate(0, 3, overlap_ticks=2)
        done += eng.run(max_steps=64)
        held = set(ports.values()) <= set(PORTS.in_use(eng.ctx.model_comm))
        same = eng.pool.ports() == ports
        eng.shutdown()
        freed = not set(ports.values()) & set(PORTS.in_use(eng.ctx.model_comm))
        if not (held and same and freed and len(ports) > 2):
            raise AssertionError(f"tp serve pool: ports {ports} held {held}, unchanged {same}, "
                                 f"released at shutdown {freed}")
        return {r.uid: r.out for r in done}

    plain, migrated = serve(False), serve(True)
    if plain != migrated:
        raise AssertionError(f"tp serve: the migrated request's tokens changed: {migrated} != "
                             f"{plain}")
    log("tp serve: a slot migrated over serve.migrate with 2 ticks in flight decodes the same "
        "tokens; the pool held its ports to shutdown and released them there")

    # ms per decode step at P = 8 beside tp = 1, in turns; then the profile
    turns = _decode_turns(dev, cfg, params, tp_params)
    del params, tp_params
    torch.cuda.empty_cache()

    # a float32 copy at full width, cut in depth, against tp = 1
    cfg32 = cfg.scaled(n_layers=TP_F32_LAYERS, dtype="float32")
    p32 = init_lm(cfg32, torch.Generator(device=dev).manual_seed(seed + 1), dev)
    ctx8 = make_ctx((1, TP), comm_mode="smi:static", device=dev)
    p32_8 = shard_params(p32, cfg32, ctx8)
    c1, c8 = lm_caches(cfg32, 4, 256, ctx1, dev), lm_caches(cfg32, 4, 256, ctx8, dev)
    worst = 0.0
    for t in range(TP_DECODE_STEPS):
        tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (4,)).astype(np.int32)).to(dev)
        want, _ = lm_decode_step(p32, c1, tok, t, cfg32, ctx1)
        got, _ = lm_decode_step(p32_8, c8, tok, t, cfg32, ctx8)
        if not all(torch.equal(got[r], got[0]) for r in range(TP)):
            raise AssertionError("tp decode float32: the ranks' gathered logits differ")
        excess = ((got[0] - want).abs() - (TP_F32_TOL + TP_F32_TOL * want.abs())).max()
        worst = max(worst, float((got[0] - want).abs().max()))
        if float(excess) > 0:
            raise AssertionError(f"tp decode float32 step {t}: beyond {TP_F32_TOL} rtol/atol "
                                 f"(max abs err {worst})")
    log(f"tp decode float32 ({TP_F32_LAYERS} layers, full width): within {TP_F32_TOL} rtol/atol "
        f"of tp = 1 over {TP_DECODE_STEPS} steps, max abs err {worst:.3e}")
    del p32, p32_8, c1, c8
    torch.cuda.empty_cache()
    return {"runs": {k: {m: v[m] for m in ("tok_per_s", "ms_per_step", "decode_steps",
                                              "tokens")} for k, v in runs.items()},
            "launches_a": launches, "a_per_step_tuned_runs": a_per_step_runs,
            "a_per_step_decode": a_per_step, "fused_vs_static": fused_check, "plans": plans,
            "min_cos_vs_tp1": min(cos), **turns, "f32_max_abs_err": worst}


def phase_validate_comm() -> dict:
    """Phase 29: ``launch.serve --validate-comm`` on yi-6b at full width
    and depth, 4 slots, 256 positions, at each
    of :data:`VALIDATE_MESHES` on each of :data:`VALIDATE_WIRES`: every
    ``serve.*`` tag, migration legs included, equal to the prediction byte
    for byte and step for step.  Returns the tables and A's launches."""
    import torch

    from repro_torch.launch import serve as launch_serve

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mesh in VALIDATE_MESHES:
            for wire in VALIDATE_WIRES:
                path = os.path.join(tmp, "v.json")
                reset_counts()
                rc = launch_serve.main(["--arch", "yi-6b", "--mesh", mesh, "--comm-mode", wire, "--slots", "4",
                                        "--capacity", "256", "--validate-comm", "--json", path])
                torch.cuda.synchronize()
                a = _a_launches()
                torch.cuda.empty_cache()
                if rc != 0:
                    raise AssertionError(f"validate-comm mesh {mesh} {wire}: rc={rc}")
                res = json.loads(Path(path).read_text())
                out[f"{mesh} {wire}"] = {"tags": res["measured"], "A": a}
                log(f"validate-comm yi-6b mesh {mesh} {wire}: "
                    f"{len(res['measured'])} tags equal, "
                    f"{sum(e['bytes'] for e in res['measured'].values())} B a rank; kernel A {a}")
    return out


#: phase 30: the ring-attention prefill's tags on the attention wire, and
#: the default layout's
RING_TAGS = ("tp.attn.qkv", "tp.attn.out", "tp.attn.ring")
DEFAULT_ATTN_TAGS = ("tp.attn.qkv", "tp.attn.kv", "tp.attn.out")


def phase_ring_prefill(dev, tp_params, seed: int = 19) -> dict:
    """Phase 30: yi-6b at full width and depth, P = 8, 4096 tokens, through
    ``build_prefill(mesh=(1, 8), comm_mode="smi:static", ring_attn=True)``
    against the default TP prefill of phase 19 (``build_prefill``, no D),
    on phase 19's params: row cosine >= 0.999; wall and device ms of both
    in turns; the attention wire's bytes a layer of both layouts."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.steps import build_prefill
    from repro_torch.parallel import ledger

    cfg = get_arch("yi-6b")
    shape = ShapeConfig("prefill_4k", PREFILL_TOKENS, 1, "prefill")
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                  (1, PREFILL_TOKENS))).to(dev)
    steps = {"default": build_prefill(cfg, shape, mesh=(1, TP), comm_mode="smi:static",
                                      device=dev),
             "ring": build_prefill(cfg, shape, mesh=(1, TP), comm_mode="smi:static",
                                   ring_attn=True, device=dev)}
    leds, outs = {}, {}
    for who, step in steps.items():
        with ledger.capture() as leds[who]:
            outs[who] = step(tp_params, tokens)  # warm-up, its wire traffic captured
    torch.cuda.synchronize()
    h = outs["ring"]
    if tuple(h.shape) != (1, PREFILL_TOKENS, cfg.d_model) or not torch.isfinite(h).all():
        raise AssertionError("ring-attention prefill hidden states not finite or misshapen")
    cos = float(_row_cos(h, outs["default"]).min())
    if cos < 0.999:
        raise AssertionError(f"ring-attention prefill: min row cosine {cos} against the default")
    del outs
    ms, turns = _in_turns({who: functools.partial(step, tp_params, tokens)
                           for who, step in steps.items()},
                          ("default", "ring", "ring", "default"))
    device = {}
    for who in ("default", "ring"):
        device[who], _, _ = _profile_device_ms(lambda: steps[who](tp_params, tokens))
    per_layer = {who: {t: leds[who].by_tag[t]["bytes"] // cfg.n_layers for t in tags}
                 for who, tags in (("default", DEFAULT_ATTN_TAGS), ("ring", RING_TAGS))}
    attn = {who: sum(v.values()) for who, v in per_layer.items()}
    log(f"ring prefill: {ms['ring']:.3f} ms (device {device['ring']:.3f}) against the default "
        f"TP prefill {ms['default']:.3f} ms (device {device['default']:.3f}), turns "
        f"{json.dumps(turns)}; min row cosine {cos:.6f}")
    log(f"ring prefill attention wire a layer a rank: ring {json.dumps(per_layer['ring'])} = "
        f"{attn['ring']} B against default {json.dumps(per_layer['default'])} = "
        f"{attn['default']} B: x{attn['default'] / attn['ring']:.3f} (the reference's docstring "
        f"claims x{cfg.d_model / (2 * cfg.n_kv_heads * cfg.hd):.0f} on the activation rings)")
    return {"ms": ms, "turns_ms": turns, "device_ms": device, "min_cos_vs_default": cos,
            "attn_bytes_per_layer": per_layer, "attn_cut": attn["default"] / attn["ring"],
            "ledger_bytes": {k: v.tag_bytes() for k, v in leds.items()}}


# -- slice 9: Mamba2 at tp > 1 and MoE (phases 31-36) ---------------------------------

SSM_ARCH = "mamba2-2.7b"
MOE_ARCH = "qwen3-moe-30b-a3b"
#: ticks a turn of phases 32's and 35's in-process decode timing (a
#: qwen3-moe tick at P = 8 takes 0.3-0.9 s of host time)
SLICE9_TICKS = 2
#: phase 34's float32 check: its depth, its tokens (few, so that a near-tie
#: of the k-th and (k+1)-th expert is unlikely to flip between the two runs'
#: float32 sums), and phase 28's tolerance
MOE_F32_LAYERS = 4
MOE_F32_TOKENS = 256
#: phase 36's runs (arch, mesh); qwen3-moe at 2,4 runs on FSDP weights: a
#: model shard's 15.3 GB of bfloat16 weights (30.53 B parameters over 4
#: model ranks) passes the FSDP rule's 10 GB.  The reference counts the
#: parameters in int32 there (4.763 B) and would not shard them
#: (ROADMAP.md §3); the port counts them from the config
VALIDATE_SLICE9 = ((SSM_ARCH, "1,8"), (SSM_ARCH, "2,4"), (MOE_ARCH, "1,8"), (MOE_ARCH, "2,4"))


def _tp_prefill_checks(cfg, params, tokens, extra, dev, name: str,
                       inspect=None) -> tuple[dict, dict]:
    """The TP prefill of ``cfg`` at P = 8 over ``smi:static`` with kernel D
    injected, on ``params`` (split by ``shard_params``) and in turns with
    tp = 1: D, E and F launched as the closed form says (all on wgmma), the
    hidden states finite, the ledger equal to its closed form; over
    ``smi:fused`` bit-equal, kernel A launched once a reduce-scatter ring
    step; the bfloat16 row cosine against tp = 1 reported.  ``inspect(
    tp_params, ctx, run_tp, run_tp1)``, if given, runs next, before the
    P = 8 copy is freed; its dict joins the results.  Returns the launches
    and the results."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.interop import shard_params
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.ssd import ssd_scan_kernel
    from repro_torch.launch.steps import build_prefill
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import gather_hidden, lm_prefill
    from repro_torch.parallel import ledger

    ctxs = {m: make_ctx((1, TP), comm_mode=m, matmul_fn=matmul, device=dev)
            for m in ("smi:static", "smi:fused")}
    before = torch.cuda.memory_allocated()
    tp_params = shard_params(params, cfg, ctxs["smi:static"])
    copied = (torch.cuda.memory_allocated() - before) / 1e9
    tp1 = build_prefill(cfg, ShapeConfig("prefill_4k", PREFILL_TOKENS, 1, "prefill"), device=dev)

    def run_tp(mode="smi:static"):
        return gather_hidden(lm_prefill(tp_params, tokens, cfg, ctxs[mode],
                                        capacity=PREFILL_TOKENS, extra_embeds=extra))

    def run_tp1():
        return tp1(params, tokens, extra)

    with ledger.capture() as led:
        run_tp()
    want_led = _tp_closed_form(cfg, TP, PREFILL_TOKENS)
    if led.by_tag != want_led:
        raise AssertionError(f"{name} TP prefill ledger {led.by_tag} != closed form {want_led}")
    reset_counts()
    hidden, _ = _timed_ms(run_tp)
    got = {"D": (matmul.launches, matmul.wgmma_launches),
           "E": (flash_attention_kernel.launches, flash_attention_kernel.wgmma_launches),
           "F": (ssd_scan_kernel.launches, ssd_scan_kernel.wgmma_launches)}
    kinds = cfg.layer_pattern
    want = {"D": _d_launches(cfg, TP), "E": kinds.count("attn") + kinds.count("moe"),
            "F": kinds.count("ssm")}
    if got != {k: (n, n) for k, n in want.items()}:
        raise AssertionError(f"{name} TP prefill launched (all, on wgmma) {got}; want {want}, "
                             f"all on wgmma")
    if tuple(hidden.shape) != (1, PREFILL_TOKENS, cfg.d_model) or not torch.isfinite(hidden).all():
        raise AssertionError(f"{name} TP prefill hidden states not finite or misshapen")
    h1 = run_tp1()
    cos = _row_cos(hidden, h1)
    reset_counts()
    fused = run_tp("smi:fused")
    torch.cuda.synchronize()
    a = _a_launches()
    rs_steps = _rs_calls(cfg) * (TP - 1)
    if not same_bits(fused, hidden) or a != {"shift": rs_steps, "fold": 0}:
        raise AssertionError(f"{name} TP prefill over smi:fused: same bits "
                             f"{same_bits(fused, hidden)}, kernel A {a} (want {rs_steps} "
                             f"gather-fused)")
    del fused, h1
    ms, turns = _in_turns({"tp1": run_tp1, f"tp{TP}": run_tp},
                          ("tp1", f"tp{TP}", f"tp{TP}", "tp1"))
    busy, rows, wall = _profile_device_ms(run_tp)
    split = _profile_split(rows)
    log(f"{name} TP prefill P={TP}: {ms[f'tp{TP}']:.3f} ms "
        f"({PREFILL_TOKENS / ms[f'tp{TP}'] * 1e3:.1f} tok/s) against tp = 1 {ms['tp1']:.3f} ms, "
        f"turns {json.dumps(turns)}; launched (all, on wgmma) {json.dumps(got)}; the P = 8 copy "
        f"added {copied:.2f} GB; ledger equal to the closed form {json.dumps(led.tag_bytes())}")
    log(f"{name} TP prefill over smi:fused: bit-equal to smi:static, kernel A {a}")
    log(f"{name} TP prefill bf16 against tp = 1: row cosine min {float(cos.min()):.6f} mean "
        f"{float(cos.mean()):.6f} (reported)")
    log(f"{name} TP prefill profile: device {busy:.3f} ms of {wall:.3f} ms wall (idle "
        f"{1 - busy / wall:.1%}): " + ", ".join(f"{k} {v:.3f} ms ({v / busy:.1%})"
                                                for k, v in split.items()))
    for kname, t in rows[:8]:
        log(f"{name} TP prefill profile: {t:9.3f} ms  {kname[:90]}")
    res = dict(ms=ms, turns_ms=turns, tok_per_s=PREFILL_TOKENS / ms[f"tp{TP}"] * 1e3,
               launches=got, launches_a_fused=a, copied_gb=copied,
               min_cos_vs_tp1=float(cos.min()), mean_cos_vs_tp1=float(cos.mean()),
               device_ms=busy, profiled_wall_ms=wall, device_idle_share=1 - busy / wall,
               device_split_ms=split, ledger_bytes=led.tag_bytes())
    del hidden
    if inspect is not None:
        res |= inspect(tp_params, ctxs["smi:static"], run_tp, run_tp1)
    del tp_params
    torch.cuda.empty_cache()
    return {"D": got["D"][0], "E": got["E"][0], "F": got["F"][0], "A": a}, res


def phase_ssm_tp_prefill(dev, seed: int = 16) -> tuple[dict, dict]:
    """Phase 31: mamba2-2.7b at full width and depth, 4096 tokens, bfloat16,
    on phase 16's weights and tokens (its seed), through
    :func:`_tp_prefill_checks`: kernel F launched once a layer over the 8 x
    80 / 8 head rows, all on wgmma; D 3 x 8 times a layer (two ``ssm.in``
    and the ``ssm.out`` ring steps); A 455 over ``smi:fused``.  F gated layer
    by layer (each block's update from its own input, F against the plain
    scan, row cosine >= 0.999) and in float32 at full width, cut to
    :data:`TP_F32_LAYERS` layers as phases 28 and 34 are (F on the FMA
    kernel within phase 28's :data:`TP_F32_TOL` rtol and atol of the plain
    scan at P = 8 and of the plain tp = 1 prefill); the bfloat16 row cosine
    against tp = 1 is reported (rounding amplified over 64 layers,
    ROADMAP.md §3)."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.interop import shard_params
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.ssd import ssd_scan_kernel
    from repro_torch.launch.steps import build_prefill
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import gather_hidden, init_lm, lm_prefill
    from repro_torch.models.model import embed_tokens_sp, model_dtype
    from repro_torch.models.transformer import _layer, apply_block

    cfg = get_arch(SSM_ARCH)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                     dtype=model_dtype(cfg))
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                  (1, PREFILL_TOKENS))).to(dev)

    def per_layer(tp_params, ctx, _run_tp, _run_tp1):
        # F layer by layer at P = 8: each block's update from its own input
        x = embed_tokens_sp(tp_params, tokens, cfg, ctx)
        worst = (1.0, -1)
        for i in range(cfg.n_layers):
            p = _layer(tp_params["stack"]["periods"][0], i)
            got, _ = apply_block(p, "ssm", x, cfg, ctx, use_kernel=True)
            want, _ = apply_block(p, "ssm", x, cfg, ctx, use_kernel=False)
            c = float(_row_cos(gather_hidden(got - x), gather_hidden(want - x)).min())
            worst = min(worst, (c, i))
            x = got
        torch.cuda.synchronize()
        log(f"mamba2 TP prefill per layer (bf16, F vs plain on each layer's own input): min row "
            f"cosine {worst[0]:.6f} (layer {worst[1]})")
        if worst[0] < 0.999:
            raise AssertionError(f"mamba2 TP layer {worst[1]}: F's update disagrees with the "
                                 f"plain scan's, min row cosine {worst[0]}")
        return {"min_cos_per_layer": worst[0]}

    launches, res = _tp_prefill_checks(cfg, params, tokens, None, dev, "mamba2", per_layer)
    del params
    torch.cuda.empty_cache()

    # float32 at full width, cut in depth: F (the FMA kernel) at P = 8 against
    # the plain scan at P = 8 and the plain tp = 1 prefill
    ctx = make_ctx((1, TP), comm_mode="smi:static", matmul_fn=matmul, device=dev)
    cfg32 = cfg.scaled(n_layers=TP_F32_LAYERS, dtype="float32")
    p32 = init_lm(cfg32, torch.Generator(device=dev).manual_seed(seed), dev, dtype=torch.float32)
    tp32 = shard_params(p32, cfg32, ctx)

    def run_tp(use_kernel=None):
        return gather_hidden(lm_prefill(tp32, tokens, cfg32, ctx, capacity=PREFILL_TOKENS,
                                        use_kernel=use_kernel))

    reset_counts()
    got32 = run_tp()
    torch.cuda.synchronize()
    if (ssd_scan_kernel.launches, ssd_scan_kernel.wgmma_launches) != (TP_F32_LAYERS, 0):
        raise AssertionError(f"mamba2 float32 TP prefill: F launched "
                             f"{ssd_scan_kernel.launches} times, {ssd_scan_kernel.wgmma_launches} "
                             f"on wgmma")
    plain32 = run_tp(use_kernel=False)
    del tp32
    shape = ShapeConfig("prefill_4k", PREFILL_TOKENS, 1, "prefill")
    ref32 = build_prefill(cfg32, shape, device=dev)(p32, tokens, use_kernel=False)
    cos32 = float(_row_cos(got32, plain32).min())
    cos32_tp1 = float(_row_cos(got32, ref32).min())
    err32, err32_tp1 = max_abs_err(got32, plain32), max_abs_err(got32, ref32)
    ex32, ex32_tp1 = f32_excess(got32, plain32), f32_excess(got32, ref32)
    log(f"mamba2 TP prefill float32 ({TP_F32_LAYERS} layers, full width): F vs plain max abs "
        f"err {err32:.3e} (min row cosine {cos32:.8f}); vs the tp = 1 plain prefill "
        f"{err32_tp1:.3e} ({cos32_tp1:.8f}); within {TP_F32_TOL} rtol/atol: "
        f"{max(ex32, ex32_tp1) <= 0}")
    if not torch.isfinite(got32).all() or max(ex32, ex32_tp1) > 0:
        raise AssertionError(f"mamba2 float32 TP prefill beyond {TP_F32_TOL} rtol/atol: max abs "
                             f"err {err32} against the plain scan, {err32_tp1} against tp = 1")
    del p32, got32, plain32, ref32
    torch.cuda.empty_cache()
    res |= dict(f32_layers=TP_F32_LAYERS, f32_max_abs_err_vs_plain=err32,
                f32_max_abs_err_vs_tp1=err32_tp1, f32_min_cos=cos32, f32_min_cos_vs_tp1=cos32_tp1)
    return launches, res


def phase_ssm_tp_serving(dev, seed: int = 32) -> dict:
    """Phase 32: ``launch.serve --arch mamba2-2.7b --mesh 1,8`` with phase
    14's requests, both engines, on ``smi:static`` and the bare ``smi``:
    tokens equal across the four runs; kernel A held on the decode itself as phase 28 holds it
    (the first steps over a pinned ``smi:fused`` runtime bit-equal to
    ``smi:static``, A's launches rising each fused step and never on a
    static one, its operands re-run against its plain version); then ms a
    decode step at P = 8 beside tp = 1 in turns, the device's idle share,
    and A's launches a step on the tuned wire."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.interop import shard_params
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import init_lm
    from repro_torch.models.model import model_dtype

    runs, launches = _launcher_runs(SSM_ARCH, f"1,{TP}", TP_SERVE_WIRES)
    a_step = _a_per_step(runs, launches)
    cfg = get_arch(SSM_ARCH)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                     dtype=model_dtype(cfg))
    tp_params = shard_params(params, cfg, make_ctx((1, TP), comm_mode="smi:static", device=dev))
    fused = _fused_against_static(cfg, tp_params, dev, np.random.RandomState(seed))
    turns = _decode_turns(dev, cfg, params, tp_params, SLICE9_TICKS)
    del params, tp_params
    torch.cuda.empty_cache()
    log(f"mamba2 tp serve: kernel A a decode step on the tuned wire {json.dumps(a_step)}")
    return {"runs": _brief(runs), "launches_a": launches, "a_per_step_tuned_runs": a_step,
            "fused_vs_static": fused, **turns}


def phase_moe_prefill(dev, seed: int = 33) -> tuple[object, dict]:
    """Phase 33: qwen3-moe-30b-a3b at full width and depth (48 layers, 128
    experts, 61.1 GB of bfloat16 weights) through ``build_prefill`` on 4096
    tokens: ms, tokens/s, kernel E launched once a layer, all on wgmma;
    device time by kernel and the idle share.  Returns the params (phase
    34's) and the results."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.launch.steps import build_prefill
    from repro_torch.models import init_lm
    from repro_torch.models.common import tree_leaves_with_path
    from repro_torch.models.model import model_dtype

    cfg = get_arch(MOE_ARCH)
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                     dtype=model_dtype(cfg))
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in tree_leaves_with_path(params))
    log(f"moe prefill: {cfg.name} params {n} ({n * 2 / 1e9:.2f} GB bf16) drawn in "
        f"{time.perf_counter() - t0:.1f}s")
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                  (1, PREFILL_TOKENS))).to(dev)
    step = build_prefill(cfg, ShapeConfig("prefill_4k", PREFILL_TOKENS, 1, "prefill"), device=dev)
    step(params, tokens)
    reset_counts()
    hidden, ms = _timed_ms(lambda: step(params, tokens))
    e, e_wgmma = flash_attention_kernel.launches, flash_attention_kernel.wgmma_launches
    if (e, e_wgmma) != (cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"moe prefill launched E {e} times ({e_wgmma} on wgmma), not "
                             f"{cfg.n_layers}")
    if tuple(hidden.shape) != (1, PREFILL_TOKENS, cfg.d_model) or not torch.isfinite(hidden).all():
        raise AssertionError("moe prefill hidden states not finite or misshapen")
    busy, rows, wall = _profile_device_ms(lambda: step(params, tokens))
    split = _profile_split(rows)
    log(f"moe prefill: {cfg.name} {ms:.3f} ms for {PREFILL_TOKENS} tokens "
        f"({PREFILL_TOKENS / ms * 1e3:.1f} tok/s), E launched {e} times ({e_wgmma} on wgmma); "
        f"device {busy:.3f} ms of {wall:.3f} ms wall (idle {1 - busy / wall:.1%}): " +
        ", ".join(f"{k} {v:.3f} ms ({v / busy:.1%})" for k, v in split.items()))
    for name, t in rows[:12]:
        log(f"moe prefill profile: {t:9.3f} ms  {name[:90]}")
    return params, dict(ms=ms, tok_per_s=PREFILL_TOKENS / ms * 1e3, launches_e=e,
                        wgmma_launches_e=e_wgmma, device_ms=busy, profiled_wall_ms=wall,
                        device_idle_share=1 - busy / wall, device_split_ms=split,
                        top_kernels_ms=[(k[:60], t) for k, t in rows[:12]], params=n)


def _recording_routes():
    """A context in which every ``models.moe.route`` call's sorted choices
    are kept, in call order."""
    from contextlib import contextmanager
    from unittest import mock

    from repro_torch.models import moe as moe_mod

    @contextmanager
    def ctx():
        seen = []
        route = moe_mod.route

        def recording(router, xf, cfg):
            vals, idx, aux = route(router, xf, cfg)
            seen.append(idx.sort(dim=-1).values)
            return vals, idx, aux

        with mock.patch.object(moe_mod, "route", recording):
            yield seen

    return ctx()


def phase_moe_tp_prefill(dev, params, seed: int = 33) -> tuple[dict, dict]:
    """Phase 34: phase 33's prefill at P = 8 through
    :func:`_tp_prefill_checks`, on the same weights (the experts shared as
    views, the attention, embedding and head copied): D 2 x 8 launches a
    layer (Q and the out-projection), E one (over the 8 ranks' heads), A 679
    over ``smi:fused``.  The share of routing choices that agree with tp = 1
    (bfloat16, full depth) is reported.  Then, the bfloat16 weights freed, a
    float32 copy cut to :data:`MOE_F32_LAYERS` layers at full width
    (:func:`phase_moe_f32`): the chosen experts equal at every layer, and
    the hidden states within phase 28's float32 tolerance
    (:data:`TP_F32_TOL` rtol and atol) of tp = 1."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.common import tree_leaves_with_path

    cfg = get_arch(MOE_ARCH)
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                  (1, PREFILL_TOKENS))).to(dev)

    def routing(tp_params, _ctx, run_tp, run_tp1):
        experts = [(a, b) for (path, a), (_, b) in zip(tree_leaves_with_path(tp_params),
                                                        tree_leaves_with_path(params), strict=True)
                   if path[-2:-1] == ("moe",) and path[-1] in ("w_gate", "w_up", "w_down")]
        if not experts or any(a.data_ptr() != b.data_ptr() for a, b in experts):
            raise AssertionError("moe TP params: the expert leaves are not views of tp = 1's")
        with _recording_routes() as routes_tp:
            run_tp()
        with _recording_routes() as routes_1:
            run_tp1()
        agree = torch.stack([(a == b).all(-1) for a, b in zip(routes_tp, routes_1, strict=True)])
        chosen = torch.stack([(a[..., None] == b[..., None, :]).any(-1).float().mean(-1)
                              for a, b in zip(routes_tp, routes_1)])
        log(f"moe TP prefill routing against tp = 1 (bf16): {float(agree.float().mean()):.4%} of "
            f"(token, layer) top-{cfg.top_k} sets equal, {float(chosen.mean()):.4%} of the choices "
            f"shared; first layer {float(agree[0].float().mean()):.4%}; the experts shared as "
            f"views")
        return dict(routing_sets_equal=float(agree.float().mean()),
                    routing_choices_shared=float(chosen.mean()))

    return _tp_prefill_checks(cfg, params, tokens, None, dev, "moe", routing)


def phase_moe_f32(dev, seed: int = 34) -> dict:
    """Phase 34's float32 check (run once phase 33's weights are freed);
    see :func:`phase_moe_tp_prefill`."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.interop import shard_params
    from repro_torch.kernels.matmul import matmul
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import gather_hidden, init_lm, lm_prefill

    cfg = get_arch(MOE_ARCH).scaled(n_layers=MOE_F32_LAYERS, dtype="float32")
    p32 = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev, dtype=torch.float32)
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                  (1, MOE_F32_TOKENS))).to(dev)
    ctx8 = make_ctx((1, TP), comm_mode="smi:static", matmul_fn=matmul, device=dev)
    with _recording_routes() as r1:
        want = lm_prefill(p32, tokens, cfg, make_ctx(), capacity=MOE_F32_TOKENS)
    with _recording_routes() as r8:
        got = gather_hidden(lm_prefill(shard_params(p32, cfg, ctx8), tokens, cfg, ctx8,
                                       capacity=MOE_F32_TOKENS))
    torch.cuda.synchronize()
    flips = [int((a != b).any(-1).sum()) for a, b in zip(r8, r1, strict=True)]
    err = max_abs_err(got, want)
    excess = f32_excess(got, want)
    log(f"moe float32 ({MOE_F32_LAYERS} layers, full width, {MOE_F32_TOKENS} tokens): tokens "
        f"whose experts differ from tp = 1 by layer {flips}; max abs err {err:.3e}, within "
        f"{TP_F32_TOL} rtol/atol: {excess <= 0}")
    if any(flips):
        raise AssertionError(f"moe float32 P = {TP}: the chosen experts differ from tp = 1 "
                             f"({flips} tokens by layer)")
    if excess > 0 or not torch.isfinite(got).all():
        raise AssertionError(f"moe float32 P = {TP}: beyond {TP_F32_TOL} rtol/atol of tp = 1 "
                             f"(max abs err {err})")
    del p32, got, want
    torch.cuda.empty_cache()
    return {"layers": MOE_F32_LAYERS, "tokens": MOE_F32_TOKENS, "max_abs_err": err,
            "routing_flips": flips}


def phase_moe_serving(dev, seed: int = 35) -> dict:
    """Phase 35: ``launch.serve --arch qwen3-moe-30b-a3b`` with phase 14's
    requests, both engines, at tp = 1 and at ``--mesh 1,8`` on
    ``smi:static`` and the bare ``smi``: tokens equal across the runs at
    each tp; kernel A held on
    the P = 8 decode as phase 32 holds it (a pinned ``smi:fused`` decode
    bit-equal to ``smi:static``);
    then ms a decode step at P = 8 beside tp = 1 in turns, the idle share,
    and A's launches a step on the tuned wire."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.interop import shard_params
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import init_lm
    from repro_torch.models.model import model_dtype

    runs1, _ = _launcher_runs(MOE_ARCH, "1,1", ("smi",))
    runs8, launches = _launcher_runs(MOE_ARCH, f"1,{TP}", TP_SERVE_WIRES)
    a_step = _a_per_step(runs8, launches)
    cfg = get_arch(MOE_ARCH)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                     dtype=model_dtype(cfg))
    tp_params = shard_params(params, cfg, make_ctx((1, TP), comm_mode="smi:static", device=dev))
    fused = _fused_against_static(cfg, tp_params, dev, np.random.RandomState(seed))
    turns = _decode_turns(dev, cfg, params, tp_params, SLICE9_TICKS)
    del params, tp_params
    torch.cuda.empty_cache()
    log(f"moe tp serve: kernel A a decode step on the tuned wire {json.dumps(a_step)}")
    return {"runs_tp1": _brief(runs1), f"runs_tp{TP}": _brief(runs8), "launches_a": launches,
            "a_per_step_tuned_runs": a_step, "fused_vs_static": fused, **turns}


def phase_validate_slice9() -> dict:
    """Phase 36: ``launch.serve --validate-comm`` over ``smi:static``, 4
    slots, 256 positions, full width and depth, for mamba2-2.7b and
    qwen3-moe-30b-a3b at :data:`VALIDATE_SLICE9`'s meshes: every tag,
    migration legs included, equal to the prediction byte for byte and
    step for step; qwen3-moe at ``2,4`` on FSDP weights (the launcher's rule),
    its step gathering every layer's over the data ring (``fsdp.gather``,
    in the port's prediction only)."""
    out = _validate_comm_runs(VALIDATE_SLICE9)
    if "fsdp.gather" not in out[f"{MOE_ARCH} 2,4"]:
        raise AssertionError(f"validate-comm {MOE_ARCH} mesh 2,4: not on FSDP weights")
    return out


# -- slice 10: the RG-LRU hybrid and the VLM and audio frontends -----------------------

RG_ARCH = "recurrentgemma-9b"
VLM_ARCH = "internvl2-1b"
AUDIO_ARCH = "musicgen-medium"
#: phase 38's float32 check: one (rec, rec, attn) period and the two
#: remainder rec layers, at full width, on few tokens (the 256,000-row
#: embedding and head take 8.4 GB in float32)
RG_F32_LAYERS = 5
RG_F32_TOKENS = 256
#: phase 40's float32 check: its depth
VLM_F32_LAYERS = 4
#: phase 42's runs (arch, mesh)
VALIDATE_SLICE10 = ((RG_ARCH, "1,8"), (RG_ARCH, "2,4"), (AUDIO_ARCH, "1,8"),
                    (AUDIO_ARCH, "2,4"), (VLM_ARCH, "1,8"))


def _annotated_ms(fn, targets: dict) -> dict:
    """Device ms of each of ``targets`` (name -> (module, attribute)) in one
    call of ``fn``: each function wrapped in a ``torch.profiler`` range of
    its name for the call, the range's device time read from the profile as
    the sum of the kernels its host ops launched (the host-side range; the
    device-side span of the same name would count the gaps between them)."""
    import contextlib
    from unittest import mock

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, f):
        def inner(*a, **kw):
            with record_function(name):
                return f(*a, **kw)
        return inner

    with contextlib.ExitStack() as stack:
        for name, (mod, attr) in targets.items():
            stack.enter_context(mock.patch.object(mod, attr, ranged(name, getattr(mod, attr))))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    out = {name: 0.0 for name in targets}
    for e in prof.key_averages():
        if e.key in out and e.device_type == DeviceType.CPU:
            out[e.key] += e.device_time_total / 1e3
    return out


def phase_rg_prefill(dev, seed: int = 37) -> tuple[object, dict]:
    """Phase 37: recurrentgemma-9b at full width and depth (38 layers: 12
    periods of (rec, rec, attn) and 2 remainder rec layers, bfloat16)
    through ``build_prefill`` on 4096 tokens: ms, tokens/s, kernel E launched
    once an attention layer (12), all on wgmma at head dim 256 with the
    2048-token window; hidden states finite and within a row cosine of
    0.999 of the plain attention's; the device time by kind (E, the RG-LRU
    scan, its elementwise gates, the GEMMs) and the idle share.  Returns the
    params (phase 38's) and the results."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.launch.steps import build_prefill
    from repro_torch.models import init_lm
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.models.common import tree_leaves_with_path
    from repro_torch.models.model import model_dtype

    cfg = get_arch(RG_ARCH)
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                     dtype=model_dtype(cfg))
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in tree_leaves_with_path(params))
    log(f"rg prefill: {cfg.name} params {n} ({n * 2 / 1e9:.2f} GB bf16) drawn in "
        f"{time.perf_counter() - t0:.1f}s; {len(params['stack']['rem'])} remainder layers")
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                  (1, PREFILL_TOKENS))).to(dev)
    step = build_prefill(cfg, ShapeConfig("prefill_4k", PREFILL_TOKENS, 1, "prefill"), device=dev)
    step(params, tokens)
    reset_counts()
    hidden, ms = _timed_ms(lambda: step(params, tokens))
    e, e_wgmma = flash_attention_kernel.launches, flash_attention_kernel.wgmma_launches
    n_attn = cfg.layer_pattern.count("attn")
    if (e, e_wgmma) != (n_attn, n_attn):
        raise AssertionError(f"rg prefill launched E {e} times ({e_wgmma} on wgmma), not {n_attn}")
    if tuple(hidden.shape) != (1, PREFILL_TOKENS, cfg.d_model) or not torch.isfinite(hidden).all():
        raise AssertionError("rg prefill hidden states not finite or misshapen")
    busy, rows, wall = _profile_device_ms(lambda: step(params, tokens))
    split = _profile_split(rows)
    parts = _annotated_ms(lambda: step(params, tokens),
                          {"rglru.scan": (rglru_mod, "linear_scan"),
                           "rglru.gates": (rglru_mod, "_gates"),
                           "rglru.conv": (rglru_mod, "_causal_conv")})
    # the scan alone at a layer's shape (CUDA events), once a rec layer
    n_rec = cfg.layer_pattern.count("rec")
    g = torch.Generator(device=dev).manual_seed(seed)
    ab = (torch.rand((1, 1, PREFILL_TOKENS, cfg.lru_width), generator=g, device=dev),
          torch.randn((1, 1, PREFILL_TOKENS, cfg.lru_width), generator=g, device=dev))
    scan_ms = time_ms(lambda: rglru_mod.linear_scan(*ab), reps=5, warmup=1)
    del ab
    plain = step(params, tokens, use_kernel=False)
    cos = float(_row_cos(hidden, plain).min())
    log(f"rg prefill: {ms:.3f} ms for {PREFILL_TOKENS} tokens ({PREFILL_TOKENS / ms * 1e3:.1f} "
        f"tok/s), E launched {e} times ({e_wgmma} on wgmma, head dim {cfg.hd}, window "
        f"{cfg.local_window}); against the plain attention min row cosine {cos:.6f}")
    log(f"rg prefill profile: device {busy:.3f} ms of {wall:.3f} ms wall (idle "
        f"{1 - busy / wall:.1%}): " + ", ".join(f"{k} {v:.3f} ms ({v / busy:.1%})"
                                                for k, v in split.items()))
    log(f"rg prefill RG-LRU ranges (device ms, {n_rec} rec layers): " +
        ", ".join(f"{k} {v:.3f} ({v / busy:.1%})" for k, v in parts.items()) +
        f"; the scan alone at a layer's (1, 1, {PREFILL_TOKENS}, {cfg.lru_width}) float32 "
        f"{scan_ms:.3f} ms (x {n_rec} = {scan_ms * n_rec:.3f} ms)")
    for name, t in rows[:12]:
        log(f"rg prefill profile: {t:9.3f} ms  {name[:90]}")
    if cos < 0.999:
        raise AssertionError(f"rg prefill disagrees with the plain attention: min row cosine {cos}")
    del plain
    return params, dict(ms=ms, tok_per_s=PREFILL_TOKENS / ms * 1e3, launches_e=e,
                        wgmma_launches_e=e_wgmma, device_ms=busy, profiled_wall_ms=wall,
                        device_idle_share=1 - busy / wall, device_split_ms=split,
                        rglru_ranges_ms=parts, scan_alone_ms=scan_ms,
                        min_cos_vs_plain_attention=cos,
                        top_kernels_ms=[(k[:60], t) for k, t in rows[:12]], params=n)


def phase_rg_tp_prefill(dev, params, seed: int = 37) -> tuple[dict, dict]:
    """Phase 38: phase 37's prefill at P = 8 (``_tp_prefill_checks``: D 6 x
    8 launches a rec layer and 5 x 8 an attention layer, E 12 over the 8
    ranks' heads, the single KV head selected for each; A 539 over
    ``smi:fused``), on phase 37's weights and tokens."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch

    cfg = get_arch(RG_ARCH)
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                  (1, PREFILL_TOKENS))).to(dev)
    return _tp_prefill_checks(cfg, params, tokens, None, dev, "rg")


def phase_rg_f32(dev, seed: int = 38) -> dict:
    """Phase 38's float32 check, once the bfloat16 weights are freed: the
    hybrid at full width cut to :data:`RG_F32_LAYERS` layers (the remainder
    layers among them), :data:`RG_F32_TOKENS` tokens, at P = 8 with D and E
    (E's FMA kernel) within :data:`TP_F32_TOL` rtol and atol of the plain
    tp = 1 prefill and of the plain attention at P = 8."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.interop import shard_params
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul import matmul
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import gather_hidden, init_lm, lm_prefill

    cfg = get_arch(RG_ARCH).scaled(n_layers=RG_F32_LAYERS, dtype="float32")
    p32 = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev, dtype=torch.float32)
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                                  (1, RG_F32_TOKENS))).to(dev)
    ctx8 = make_ctx((1, TP), comm_mode="smi:static", matmul_fn=matmul, device=dev)
    want = lm_prefill(p32, tokens, cfg, make_ctx(), capacity=RG_F32_TOKENS, use_kernel=False)
    p8 = shard_params(p32, cfg, ctx8)
    del p32
    reset_counts()
    got = gather_hidden(lm_prefill(p8, tokens, cfg, ctx8, capacity=RG_F32_TOKENS))
    torch.cuda.synchronize()
    e = (flash_attention_kernel.launches, flash_attention_kernel.wgmma_launches)
    plain = gather_hidden(lm_prefill(p8, tokens, cfg, ctx8, capacity=RG_F32_TOKENS,
                                     use_kernel=False))
    err1, err_plain = max_abs_err(got, want), max_abs_err(got, plain)
    ex = max(f32_excess(got, want), f32_excess(got, plain))
    log(f"rg float32 ({RG_F32_LAYERS} layers, full width, {RG_F32_TOKENS} tokens): P = {TP} with "
        f"D and E (E {e[0]} launches, {e[1]} on wgmma) against the plain tp = 1 prefill max abs "
        f"err {err1:.3e}, against the plain attention at P = {TP} {err_plain:.3e}; within "
        f"{TP_F32_TOL} rtol/atol: {ex <= 0}")
    if e != (1, 0) or ex > 0 or not torch.isfinite(got).all():
        raise AssertionError(f"rg float32 P = {TP}: E {e}, beyond {TP_F32_TOL} rtol/atol (max abs "
                             f"err {err1} against tp = 1, {err_plain} against plain attention)")
    del p8, got, want, plain
    torch.cuda.empty_cache()
    return {"layers": RG_F32_LAYERS, "tokens": RG_F32_TOKENS, "max_abs_err_vs_tp1": err1,
            "max_abs_err_vs_plain_attention": err_plain}


def phase_rg_serving(dev, seed: int = 39) -> dict:
    """Phase 39: ``launch.serve --arch recurrentgemma-9b`` with phase 14's
    requests, both engines, at tp = 1 and at ``--mesh 1,8`` on
    ``smi:static`` and the tuned wire: tokens equal across the runs at each
    tp (whether P = 8's equal
    tp = 1's is reported); a pinned ``smi:fused`` decode bit-equal to
    ``smi:static`` over 2 steps (``_fused_against_static``); ms a decode
    step at P = 8 beside tp = 1 in turns, the idle share, and A's launches a
    step on the tuned wire."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.interop import shard_params
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import init_lm
    from repro_torch.models.model import model_dtype

    runs1, _ = _launcher_runs(RG_ARCH, "1,1", ("smi",))
    runs8, launches = _launcher_runs(RG_ARCH, f"1,{TP}", TP_SERVE_WIRES)
    a_step = _a_per_step(runs8, launches)
    same = _serve_tokens(runs1) == _serve_tokens(runs8)
    cfg = get_arch(RG_ARCH)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                     dtype=model_dtype(cfg))
    tp_params = shard_params(params, cfg, make_ctx((1, TP), comm_mode="smi:static", device=dev))
    fused = _fused_against_static(cfg, tp_params, dev, np.random.RandomState(seed))
    turns = _decode_turns(dev, cfg, params, tp_params, SLICE9_TICKS)
    del params, tp_params
    torch.cuda.empty_cache()
    log(f"rg serve: kernel A a decode step on the tuned wire {json.dumps(a_step)}; P = {TP}'s "
        f"tokens equal tp = 1's: {same}")
    return {"runs_tp1": _brief(runs1), f"runs_tp{TP}": _brief(runs8), "launches_a": launches,
            "a_per_step_tuned_runs": a_step, "fused_vs_static": fused,
            "tokens_equal_tp1": same, **turns}


def phase_vlm(dev, seed: int = 40) -> tuple[dict, dict]:
    """Phase 40: internvl2-1b at full width and depth (24 layers, 14 query
    heads padded to 16 for P = 8 and 2 KV heads), bfloat16: the prefill of
    ``data.make_inputs``' 256 patch embeddings and 3840 text tokens at tp = 1
    and at P = 8 on the same weights (``_tp_prefill_checks``; E 24 launches
    at tp = 1 and at P = 8, D 960); a float32 copy cut to
    :data:`VLM_F32_LAYERS` layers whose patch positions' embeddings are
    bit-equal at tp = 1 and P = 8 (the patches themselves) and whose hidden
    states lie within :data:`TP_F32_TOL` rtol and atol; then served at
    ``--mesh 1,8`` (both engines, on ``smi:static`` and the tuned wire,
    tokens equal across the four runs; a pinned ``smi:fused`` decode
    bit-equal to ``smi:static`` over 2 steps, A's operands re-run against
    its plain version; ms a decode step at P = 8 beside tp = 1 in turns, the
    idle share), and a
    float32 copy at full depth served at P = 8 and at tp = 1 with
    phase 14's requests: every request's tokens equal (in bfloat16 the two
    reduction orders' rounding flips near-ties within a few steps)."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data import make_inputs
    from repro_torch.interop import shard_params
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.steps import build_continuous_serve, build_prefill
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import gather_hidden, init_lm, lm_prefill
    from repro_torch.models.model import embed_tokens_sp, model_dtype
    from repro_torch.serving import ContinuousEngine

    cfg = get_arch(VLM_ARCH)
    shape = ShapeConfig("prefill_4k", PREFILL_TOKENS, 1, "prefill")
    ctx8 = make_ctx((1, TP), comm_mode="smi:static", device=dev)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                     dtype=model_dtype(cfg), ctx=ctx8)
    inputs = make_inputs(cfg, shape, seed, device=dev)
    tokens, pix = inputs["tokens"], inputs["pixel_embeds"]
    tp1 = build_prefill(cfg, shape, device=dev)
    tp1(params, tokens, pix)
    reset_counts()
    h1, ms1 = _timed_ms(lambda: tp1(params, tokens, pix))
    e1 = (flash_attention_kernel.launches, flash_attention_kernel.wgmma_launches)
    if e1 != (cfg.n_layers, cfg.n_layers) or not torch.isfinite(h1).all():
        raise AssertionError(f"vlm prefill: E {e1}, want {cfg.n_layers} on wgmma")
    busy, rows, wall = _profile_device_ms(lambda: tp1(params, tokens, pix))
    log(f"vlm prefill: {cfg.name} {PREFILL_TOKENS} positions ({cfg.n_patches} patches) "
        f"{ms1:.3f} ms ({PREFILL_TOKENS / ms1 * 1e3:.1f} tok/s), E {e1[0]} launches on wgmma; "
        f"device {busy:.3f} ms of {wall:.3f} ms wall (idle {1 - busy / wall:.1%})")
    del h1
    launches, tp = _tp_prefill_checks(cfg, params, tokens, pix, dev, "vlm")
    tp_params = shard_params(params, cfg, ctx8)
    fused = _fused_against_static(cfg, tp_params, dev, np.random.RandomState(seed))
    turns = _decode_turns(dev, cfg, params, tp_params, SLICE9_TICKS)
    del params, tp_params
    torch.cuda.empty_cache()

    # float32 at full width, cut in depth: the patches exact, the rest close
    cfg32 = cfg.scaled(n_layers=VLM_F32_LAYERS, dtype="float32")
    p32 = init_lm(cfg32, torch.Generator(device=dev).manual_seed(seed), dev, ctx=ctx8)
    p8 = shard_params(p32, cfg32, ctx8)
    pix32 = pix.float()
    emb1 = embed_tokens_sp(p32, tokens, cfg32, make_ctx(), pix32)
    emb8 = gather_hidden(embed_tokens_sp(p8, tokens, cfg32, ctx8, pix32))
    npch = cfg.n_patches
    exact = same_bits(emb8[:, :npch], emb1[:, :npch]) and same_bits(emb1[:, :npch], pix32)
    want = lm_prefill(p32, tokens, cfg32, make_ctx(), capacity=PREFILL_TOKENS, extra_embeds=pix32)
    got = gather_hidden(lm_prefill(p8, tokens, cfg32, ctx8, capacity=PREFILL_TOKENS,
                                   extra_embeds=pix32))
    err, ex = max_abs_err(got, want), f32_excess(got, want)
    log(f"vlm float32 ({VLM_F32_LAYERS} layers, full width): the {npch} patch positions' "
        f"embeddings bit-equal at tp = 1 and P = {TP}: {exact}; hidden states max abs err "
        f"{err:.3e}, within {TP_F32_TOL} rtol/atol: {ex <= 0}")
    if not exact or ex > 0 or not torch.isfinite(got).all():
        raise AssertionError(f"vlm float32: patches exact {exact}, max abs err {err}")
    del p32, p8, emb1, emb8, want, got
    torch.cuda.empty_cache()

    # served at P = 8 (the launcher, bfloat16), and in float32 at full depth
    # against tp = 1 on the same weights, phase 14's requests
    runs8, a = _launcher_runs(VLM_ARCH, f"1,{TP}", TP_SERVE_WIRES)
    cfg32 = cfg.scaled(dtype="float32")
    p32 = init_lm(cfg32, torch.Generator(device=dev).manual_seed(0), dev, ctx=ctx8)
    outs = {}
    for tp, eng in (("tp1", lambda: ContinuousEngine(cfg32, p32, batch_slots=4, capacity=256)),
                    (f"tp{TP}", lambda: ContinuousEngine(
                        cfg32, shard_params(p32, cfg32, ctx8), runtime=build_continuous_serve(
                            cfg32, mesh=(1, TP), comm_mode="smi:static", batch_slots=4,
                            capacity=256, device=dev)))):
        e = eng()
        launch_serve._submit_all(e, cfg32, 8, 16)
        outs[tp] = {r.uid: r.out for r in e.run(max_steps=1024)}
        e.shutdown()
        del e
    del p32
    torch.cuda.empty_cache()
    same32 = outs["tp1"] == outs[f"tp{TP}"]
    log(f"vlm serve float32 (full depth): P = {TP}'s tokens equal tp = 1's on the same weights "
        f"for all {len(outs['tp1'])} requests: {same32}")
    if not same32:
        raise AssertionError(f"vlm serve float32: P = {TP} {outs[f'tp{TP}']} != tp = 1 "
                             f"{outs['tp1']}")
    return launches, {"prefill_tp1_ms": ms1, "launches_e_tp1": e1[0], "device_ms_tp1": busy,
                      "device_idle_share_tp1": 1 - busy / wall, "tp": tp,
                      "f32_patches_exact": exact, "f32_max_abs_err": err,
                      f"runs_tp{TP}": _brief(runs8), "launches_a": a,
                      "a_per_step_tuned_runs": _a_per_step(runs8, a),
                      "fused_vs_static": fused, "f32_serve_tokens_equal_tp1": same32,
                      "decode": turns}


def phase_audio(dev, seed: int = 41) -> tuple[dict, dict]:
    """Phase 41: musicgen-medium at full width and depth (48 layers, 24
    heads, GELU, 4 codebooks), bfloat16: the prefill of ``data.make_inputs``'
    4096 frames x 4 codebooks at tp = 1 and P = 8 on the same weights
    (``_tp_prefill_checks``: E 48, D 1,536); served with phase 14's
    requests (4-codebook prompts) at tp = 1 and ``--mesh 1,8`` (both
    engines; at P = 8 on ``smi:static`` and the tuned wire): every step's
    token a list of 4, equal across the runs at each tp; a pinned ``smi:fused`` decode bit-equal to
    ``smi:static`` over 2 steps; ms a decode step at P = 8 beside tp = 1 in
    turns and the idle share; A's launches a step on the tuned wire."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data import make_inputs
    from repro_torch.interop import shard_params
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.launch.steps import build_prefill
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import init_lm
    from repro_torch.models.model import model_dtype

    cfg = get_arch(AUDIO_ARCH)
    shape = ShapeConfig("prefill_4k", PREFILL_TOKENS, 1, "prefill")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                     dtype=model_dtype(cfg))
    tokens = make_inputs(cfg, shape, seed, device=dev)["tokens"]
    tp1 = build_prefill(cfg, shape, device=dev)
    tp1(params, tokens)
    reset_counts()
    h1, ms1 = _timed_ms(lambda: tp1(params, tokens))
    e1 = (flash_attention_kernel.launches, flash_attention_kernel.wgmma_launches)
    if e1 != (cfg.n_layers, cfg.n_layers) or not torch.isfinite(h1).all() \
            or tuple(tokens.shape) != (1, PREFILL_TOKENS, cfg.n_codebooks):
        raise AssertionError(f"audio prefill: E {e1}, tokens {tuple(tokens.shape)}")
    busy, rows, wall = _profile_device_ms(lambda: tp1(params, tokens))
    log(f"audio prefill: {cfg.name} {PREFILL_TOKENS} frames x {cfg.n_codebooks} codebooks "
        f"{ms1:.3f} ms ({PREFILL_TOKENS / ms1 * 1e3:.1f} frames/s), E {e1[0]} launches on wgmma; "
        f"device {busy:.3f} ms of {wall:.3f} ms wall (idle {1 - busy / wall:.1%})")
    del h1
    launches, tp = _tp_prefill_checks(cfg, params, tokens, None, dev, "audio")
    tp_params = shard_params(params, cfg, make_ctx((1, TP), comm_mode="smi:static", device=dev))
    fused = _fused_against_static(cfg, tp_params, dev, np.random.RandomState(seed))
    turns = _decode_turns(dev, cfg, params, tp_params, SLICE9_TICKS)
    del params, tp_params
    torch.cuda.empty_cache()

    runs1, _ = _launcher_runs(AUDIO_ARCH, "1,1", ("smi",))
    runs8, a = _launcher_runs(AUDIO_ARCH, f"1,{TP}", TP_SERVE_WIRES)
    for runs in (runs1, runs8):
        if not all(len(tok) == cfg.n_codebooks for out in _serve_tokens(runs).values()
                   for tok in out):
            raise AssertionError(f"audio serve: a step's token is not {cfg.n_codebooks} codebooks")
    a_step = _a_per_step(runs8, a)
    same = _serve_tokens(runs1) == _serve_tokens(runs8)
    log(f"audio serve: (4,) tokens a step; kernel A a decode step on the tuned wire "
        f"{json.dumps(a_step)}; P = {TP}'s tokens equal tp = 1's: {same}")
    return launches, {"prefill_tp1_ms": ms1, "launches_e_tp1": e1[0], "device_ms_tp1": busy,
                      "device_idle_share_tp1": 1 - busy / wall, "tp": tp,
                      "runs_tp1": _brief(runs1), f"runs_tp{TP}": _brief(runs8),
                      "launches_a": a, "a_per_step_tuned_runs": a_step,
                      "fused_vs_static": fused, "tokens_equal_tp1": same, "decode": turns}


def _validate_comm_runs(runs) -> dict:
    """``launch.serve --validate-comm`` over ``smi:static``, 4 slots, 256
    positions, full width and depth, at each (arch, mesh) of ``runs``:
    every ``serve.*`` tag, migration legs included, equal to the prediction
    byte for byte and step for step.  Returns the measured tags by run."""
    import torch

    from repro_torch.launch import serve as launch_serve

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for arch, mesh in runs:
            path = os.path.join(tmp, "v.json")
            rc = launch_serve.main(["--arch", arch, "--mesh", mesh, "--comm-mode", "smi:static",
                                    "--slots", "4", "--capacity", "256",
                                    "--validate-comm", "--json", path])
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            if rc != 0:
                raise AssertionError(f"validate-comm {arch} mesh {mesh}: rc={rc}")
            res = json.loads(Path(path).read_text())
            out[f"{arch} {mesh}"] = res["measured"]
            log(f"validate-comm {arch} mesh {mesh} smi:static: {len(res['measured'])} tags equal, "
                f"{sum(e['bytes'] for e in res['measured'].values())} B a rank")
    return out


def phase_validate_slice10() -> dict:
    """Phase 42: :func:`_validate_comm_runs` at :data:`VALIDATE_SLICE10`'s
    (arch, mesh)."""
    return _validate_comm_runs(VALIDATE_SLICE10)


# ----------------------------------------------------------------- training
#
# Phases 43-47 (slice 11): gradients through kernels A, D, E and F, and
# training over the model axis through ``launch.steps.build_train`` and
# ``launch.train``.

TRAIN_ARCH = "yi-6b"
#: yi-6b's training cut: 8 of its 32 layers (the float32 params, gradients
#: and AdamW moments take 16 B a parameter: 30.5 GB at 8 layers, 96 GB at
#: 32), 2 sequences of train_4k's 4096 tokens (the batch cut from 256)
TRAIN_LAYERS = 8
TRAIN_SEQ = 4096
TRAIN_BATCH = 2
TRAIN_STEPS = 3
#: the per-leaf cosine the first step's gradients keep against every
#: kernel off (bfloat16 compute: the kernels round otherwise)
TRAIN_GRAD_COS = 0.999
#: phase 45's float32 check: depth and tokens (2 x 128), and its tolerance
TRAIN_F32_LAYERS = 4
TRAIN_F32_SEQ = 128
TRAIN_F32_TOL = 3e-4
TRAIN_F32_LOSS_TOL = 1e-5
#: mamba2-2.7b's training depth: all 64 layers (45.3 GB of float32 state),
#: and the depth of its float32 check against every kernel off
SSM_TRAIN_LAYERS = 64
SSM_F32_LAYERS = 4
SSM_TRAIN_STEPS = 2
#: kernel D's ring-step products of yi-6b's training step at P = 8 (2 x 4096
#: tokens: 1024 rows a rank): Q, out, MLP up and down; one shared weight; and
#: those of a data group at (2, 2, 2) (tp = 2, one 4096-token sequence: 2048
#: rows a rank)
MM_GRAD_CASES = (
    ("q_bf16", (8, 1024, 4096), (8, 4096, 512), "bfloat16"),
    ("out_bf16", (8, 1024, 512), (8, 512, 4096), "bfloat16"),
    ("mlp_up_bf16", (8, 1024, 4096), (8, 4096, 1376), "bfloat16"),
    ("mlp_down_bf16", (8, 1024, 1376), (8, 1376, 4096), "bfloat16"),
    ("shared_w_bf16", (8, 1024, 1024), (1024, 1376), "bfloat16"),
    ("mlp_up_f32", (8, 1024, 4096), (8, 4096, 1376), "float32"),
    ("tp2_q_bf16", (2, 2048, 4096), (2, 4096, 2048), "bfloat16"),
    ("tp2_out_bf16", (2, 2048, 2048), (2, 2048, 4096), "bfloat16"),
    ("tp2_mlp_up_bf16", (2, 2048, 4096), (2, 4096, 5504), "bfloat16"),
    ("tp2_mlp_down_bf16", (2, 2048, 5504), (2, 5504, 4096), "bfloat16"),
)
GRAD_TOL = {"float32": 1e-4}


def _grads_of(fn, inputs, g):
    """The gradients of ``sum(fn(*inputs) * g)`` with respect to every
    floating input (fresh leaves), and the output."""
    import torch

    leaves = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]
    out = fn(*leaves)
    wanted = [t for t in leaves if t.requires_grad]
    return out.detach(), torch.autograd.grad(out, wanted, g)


def _check_grads(name, got, want, tol, exact=False) -> float:
    """Each gradient finite, non-zero and within ``tol`` of the largest
    magnitude of ``want``'s (bit-equal when ``exact``); returns the worst
    relative error."""
    import torch

    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if a is None or not torch.isfinite(a).all() or not a.abs().max() > 0:
            raise AssertionError(f"grad {name}[{i}]: missing, not finite or all zero")
        if exact:
            if not same_bits(a, b):
                raise AssertionError(f"grad {name}[{i}]: not bit-equal to the plain version's")
            continue
        mag = float(b.abs().max())
        err = max_abs_err(a, b) / mag
        if err > tol:
            raise AssertionError(f"grad {name}[{i}]: max abs err {err:.3e} of {mag:.4g} > {tol}")
        worst = max(worst, err)
    return worst


def phase_grad_kernels(dev) -> dict:
    """Phase 43: each kernel's autograd Function against its plain version's
    autograd on the same inputs and upstream gradient, at this slice's
    shapes: A's two entry points on a (8, 1024 x 4096) ring step (float32
    and bfloat16, a ring shift and a partial permutation), bit for bit; D on
    yi-6b's training ring steps at P = 8 (its backward two launches of D
    each, counted); E on (2, 4096, 32, 128) causal; F on mamba2's (80, 4096,
    64) at state 128.  float32 within 1e-4, bfloat16 within the forward's
    tolerance (D 2e-2, E and F 1.6e-2), of the largest magnitude.  Returns
    the worst errors and D's launches."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import matmul, matmul_ref
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.transport.fused import (
        accumulate_plain,
        fused_accumulate,
        fused_shift_accumulate,
        shift_accumulate_plain,
    )

    g = torch.Generator(device=dev).manual_seed(43)
    res = {}
    # A: the add and the gather-fused ring step
    for dtype in (torch.float32, torch.bfloat16):
        a, b, up = (torch.randn((P, 1024 * 4096), generator=g, device=dev).to(dtype)
                    for _ in range(3))
        before = fused_accumulate.launches
        _, got = _grads_of(fused_accumulate, (a, b), up)
        _, want = _grads_of(accumulate_plain, (a, b), up)
        _check_grads(f"accumulate {dtype}", got, want, 0, exact=True)
        if fused_accumulate.launches != before + 1:
            raise AssertionError("grad accumulate: kernel A was not launched")
        for perm in ([(r, (r + 1) % P) for r in range(P)], PARTIAL_PERM):
            src = [-1] * P
            for s_, d_ in perm:
                src[d_] = s_
            src = torch.tensor(src, dtype=torch.int32, device=dev)
            before = fused_shift_accumulate.launches
            _, got = _grads_of(lambda x, y: fused_shift_accumulate(x, y, src), (a, b), up)
            _, want = _grads_of(lambda x, y: shift_accumulate_plain(x, y, src), (a, b), up)
            if fused_shift_accumulate.launches != before + 1:
                raise AssertionError("grad shift_accumulate: kernel A was not launched")
            for i, (x_, y_) in enumerate(zip(got, want)):
                if not same_bits(x_, y_):
                    raise AssertionError(f"grad shift_accumulate[{i}] {dtype}: not bit-equal")
        del a, b, up
    log("grad A: accumulate and shift_accumulate (ring, partial permutation) bit-equal to the "
        "plain versions' autograd, float32 and bfloat16, (8, 4194304)")
    # D: its backward is two launches of D
    res["D"] = {}
    d_launches = 0
    for name, xs, ws, dtype in MM_GRAD_CASES:
        dt = getattr(torch, dtype)
        x = torch.randn(xs, generator=g, device=dev).to(dt)
        w = (torch.randn(ws, generator=g, device=dev) * ws[-2] ** -0.5).to(dt)
        up = torch.randn(xs[:-1] + ws[-1:], generator=g, device=dev).to(dt)
        before = matmul.launches
        out, got = _grads_of(matmul, (x, w), up)
        torch.cuda.synchronize()
        if matmul.launches != before + 3:
            raise AssertionError(f"grad matmul {name}: {matmul.launches - before} launches of "
                                 f"D, not 3 (forward, dX, dW)")
        d_launches += 3
        _, want = _grads_of(matmul_ref, (x, w), up)
        tol = GRAD_TOL.get(dtype, MM_TOL[dtype])
        res["D"][name] = _check_grads(f"matmul {name}", got, want, tol)
        log(f"grad D {name}: dX, dW within {res['D'][name]:.3e} of the plain autograd "
            f"(tolerance {tol}); 3 launches")
        del x, w, up, out, got, want
    # E: its backward is the refs' recomputed
    res["E"] = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q, k, v, up = (torch.randn((TRAIN_BATCH, TRAIN_SEQ, 32, 128), generator=g,
                                   device=dev).to(dt) for _ in range(4))
        from repro_torch.kernels.flash_attention import flash_attention_kernel

        before = flash_attention_kernel.launches
        out, got = _grads_of(flash_attention, (q, k, v), up)
        if flash_attention_kernel.launches != before + 1:
            raise AssertionError("grad flash_attention: kernel E was not launched")
        want_out, want = _grads_of(lambda *t: flash_attention(*t, use_kernel=False), (q, k, v), up)
        tol = GRAD_TOL.get(dtype, FA_TOL[dtype])
        res["E"][dtype] = _check_grads(f"flash_attention {dtype}", got, want, tol)
        err = max_abs_err(out, want_out) / float(want_out.abs().max())
        log(f"grad E {dtype} (2, 4096, 32, 128) causal: dq, dk, dv within "
            f"{res['E'][dtype]:.3e} (tolerance {tol}); forward {err:.3e}")
        del q, k, v, up, out, got, want, want_out
        torch.cuda.empty_cache()
    # F: its backward is the plain scan's recomputed
    res["F"] = {}
    for dtype in ("bfloat16", "float32"):
        x, dt_, Bm, Cm, A = _ssd_inputs(dev, g, 80, TRAIN_SEQ, 64, 128, 1, dtype)
        up = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
        from repro_torch.kernels.ssd import ssd_scan_kernel

        before = ssd_scan_kernel.launches
        out, got = _grads_of(ssd_scan, (x, dt_, Bm, Cm, A), up)
        if ssd_scan_kernel.launches != before + 1:
            raise AssertionError("grad ssd_scan: kernel F was not launched")
        _, want = _grads_of(lambda *t: ssd_scan(*t, use_kernel=False), (x, dt_, Bm, Cm, A), up)
        tol = GRAD_TOL.get(dtype, SSD_TOL[dtype])
        res["F"][dtype] = _check_grads(f"ssd_scan {dtype}", got, want, tol)
        log(f"grad F {dtype} (80, 4096, 64) state 128: dx, ddt, dB, dC, dA within "
            f"{res['F'][dtype]:.3e} (tolerance {tol})")
        del x, dt_, Bm, Cm, A, up, out, got, want
    res["d_launches"] = d_launches
    return res


def _train_cfg(arch: str, layers: int, **kw):
    from repro_torch.configs import get_arch

    return get_arch(arch).scaled(n_layers=layers, **kw)


def _train_settings(comm_mode: str = "smi:fused", remat: str = "nothing", **kw):
    from repro_torch.launch.steps import TrainSettings

    return TrainSettings(comm_mode=comm_mode, remat=remat, loss_chunks=8, base_lr=3e-4,
                         warmup_steps=0, total_steps=10, **kw)


def _train_batches(cfg, seq: int, batch: int, n: int, seed: int) -> list:
    from repro_torch.data import SyntheticTokenPipeline

    pipe = SyntheticTokenPipeline(cfg.vocab_size, seq, batch, seed=seed)
    try:
        return [pipe.next() for _ in range(n)]
    finally:
        pipe.close()


def _leaf_cosines(got, want) -> list:
    """The cosine of each leaf pair, in flatten order."""
    from repro_torch.models.common import tree_flatten

    return [float((a.double() * b.double()).sum() /
                  (a.double().norm() * b.double().norm()).clamp_min(1e-300))
            for a, b in zip(tree_flatten(got), tree_flatten(want), strict=True)]


def _finite_nonzero(grads, what: str):
    """Every gradient leaf finite and not all zero (a dropped gradient
    upstream of a kernel leaves its leaves at zero)."""
    import torch

    from repro_torch.models.common import tree_leaves_with_path

    for path, t in tree_leaves_with_path(grads):
        if not torch.isfinite(t).all() or not t.abs().max() > 0:
            raise AssertionError(f"{what}: the gradient of {path} is not finite or all zero")


def _train_profile(art, state, batch) -> dict:
    """One training step under ``torch.profiler``: device ms in all and by
    part (forward, the remat recompute, E's and F's plain backwards, the
    rest of the backward, the optimizer) and the idle share.  Ranges: the
    step and its forward on the calling thread; the recompute (entered
    where the ledger is paused) and the plain backwards on autograd's
    device thread."""
    import contextlib
    from unittest import mock

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps
    from repro_torch.parallel import ledger

    orig_paused, orig_bwd, orig_loss = ledger.paused, common.RecomputeFn.backward, steps.lm_loss

    @contextlib.contextmanager
    def paused():
        with record_function("recompute"), orig_paused():
            yield

    def backward(ctx, g):
        func = getattr(ctx.plain_fn, "func", None)
        with record_function("E plain backward" if func is fa_ops._plain else
                             "F plain backward"):
            return orig_bwd(ctx, g)

    def forward(*a, **kw):
        with record_function("forward"):
            return orig_loss(*a, **kw)

    names = ("step", "forward", "recompute", "E plain backward", "F plain backward")
    with mock.patch.object(ledger, "paused", paused), \
            mock.patch.object(common.RecomputeFn, "backward", staticmethod(backward)), \
            mock.patch.object(steps, "lm_loss", forward):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function("step"):
                art["step"](state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    part = {n: 0.0 for n in names}
    busy = 0.0
    for e in prof.key_averages():
        if e.key in part:
            # the host-side range: its ops' kernels (the device-side span of
            # the same name counts the gaps too, and is left out)
            if e.device_type == DeviceType.CPU:
                part[e.key] += e.device_time_total / 1e3
        elif e.device_type == DeviceType.CUDA:
            busy += e.self_device_time_total / 1e3
    split = {"forward": part["forward"], "optimizer": part["step"] - part["forward"],
             "recompute": part["recompute"], "E plain backward": part["E plain backward"],
             "F plain backward": part["F plain backward"]}
    split["backward, the rest"] = busy - sum(split.values())
    return dict(device_ms=busy, profiled_wall_ms=wall, device_idle_share=1 - busy / wall,
                device_split_ms=split)


def phase_train_dense(dev, seed: int = 44) -> tuple[dict, dict]:
    """Phase 44: yi-6b at full width, :data:`TRAIN_LAYERS` layers, trained
    at tp = 1 through ``build_train`` on 2 x 4096 tokens a step (bfloat16
    compute, float32 AdamW state, ``remat="nothing"``, 8 loss chunks):
    the first step's gradients finite and non-zero at every leaf, within a
    per-leaf cosine of :data:`TRAIN_GRAD_COS` of every kernel off; E
    launched twice a layer a step (the forward and the remat recompute), D
    never; ms a step, tokens/s, the device time by part and the idle
    share.  Returns the results and the launches of a step."""
    import torch

    from repro_torch.models.common import tree_flatten
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.steps import build_train
    from repro_torch.optim import adamw_init

    cfg = _train_cfg(TRAIN_ARCH, TRAIN_LAYERS)
    shape = ShapeConfig("train_4k_cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    art = build_train(cfg, shape, _train_settings(), device=dev)
    t0 = time.perf_counter()
    params = art["init_params"](seed)
    n = sum(t.numel() for t in tree_flatten(params))
    batches = _train_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS + 1, seed)
    torch.cuda.synchronize()
    log(f"train tp=1: {cfg.name} x {TRAIN_LAYERS} layers, {n} params ({n * 16 / 1e9:.1f} GB "
        f"of float32 state) drawn in {time.perf_counter() - t0:.1f}s")
    reset_counts()
    (loss, _, grads), ms_grads = _timed_ms(lambda: art["grads"](params, batches[0]))
    launches = dict(E=flash_attention_kernel.launches, D=matmul.launches)
    if launches != dict(E=2 * TRAIN_LAYERS, D=0):
        raise AssertionError(f"train tp=1: a step launched {launches}, not E {2 * TRAIN_LAYERS} "
                             f"(forward and remat recompute) and D 0")
    _finite_nonzero(grads, "train tp=1")
    loss_p, _, grads_p = art["grads"](params, batches[0], use_kernel=False)
    cos = _leaf_cosines(grads, grads_p)
    del grads, grads_p
    log(f"train tp=1: loss {float(loss):.6f} (every kernel off {float(loss_p):.6f}); per-leaf "
        f"gradient cosine min {min(cos):.6f} over {len(cos)} leaves; E {launches['E']} "
        f"launches, all leaves finite and non-zero")
    if min(cos) < TRAIN_GRAD_COS:
        raise AssertionError(f"train tp=1: gradient cosine {min(cos)} < {TRAIN_GRAD_COS}")
    state = {"params": params, "opt": adamw_init(params)}
    state_bytes = sum(t.nbytes for t in tree_flatten(state))
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for b in batches[:TRAIN_STEPS - 1]:
        reset_counts()
        (_, m), t = _timed_ms(lambda: art["step"](state, b))
        if flash_attention_kernel.launches != 2 * TRAIN_LAYERS:
            raise AssertionError("train tp=1: E's launches a step changed")
        ms.append(t)
        losses.append(float(m["loss"]))
    prof = _train_profile(art, state, batches[TRAIN_STEPS - 1])
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = TRAIN_SEQ * TRAIN_BATCH
    log(f"train tp=1: steps {[f'{t:.3f}' for t in ms]} ms ({tokens / ms[-1] * 1e3:.1f} tok/s at "
        f"the last), losses {losses}; peak {peak:.2f} GB")
    log(f"train tp=1 profile: device {prof['device_ms']:.3f} ms of "
        f"{prof['profiled_wall_ms']:.3f} ms wall (idle {prof['device_idle_share']:.1%}): " +
        ", ".join(f"{k} {v:.3f} ({v / prof['device_ms']:.1%})"
                  for k, v in prof["device_split_ms"].items()))
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(params=n, ms_per_step=ms, tok_per_s=tokens / ms[-1] * 1e3, grads_ms=ms_grads,
                losses=losses, loss_first=float(loss), loss_plain=float(loss_p),
                min_grad_cos_vs_plain=min(cos), peak_gb=peak, state_bytes=state_bytes,
                **prof), launches


def phase_train_tp(dev, seed: int = 44) -> tuple[dict, dict]:
    """Phase 45: yi-6b at phase 44's cut and batch on a (1, 8) mesh with D
    on the tensor-parallel GEMMs, the same global weights and tokens: the
    first step's loss and gradients bit-equal over ``smi:fused`` and
    ``smi:static`` (A launched on the fused wire only), D's launches a step
    4x a TP forward's (forward, recompute, dX and dW), E's twice a layer;
    steps timed on both wires in turns; then float32 at
    :data:`TRAIN_F32_LAYERS` layers and 2 x :data:`TRAIN_F32_SEQ` tokens
    against tp = 1: the loss within 1e-5, every leaf's gradient and one
    AdamW step's params within 3e-4 rtol/atol."""
    import torch

    from repro_torch.models.common import tree_flatten
    from repro_torch.configs import ShapeConfig
    from repro_torch.interop import unshard_tree
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.steps import build_train
    from repro_torch.models import lm_specs
    from repro_torch.optim import adamw_init
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    cfg = _train_cfg(TRAIN_ARCH, TRAIN_LAYERS)
    shape = ShapeConfig("train_4k_cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    arts = {w: build_train(cfg, shape, _train_settings(w), mesh=(1, TP), matmul_fn=matmul,
                           device=dev) for w in ("smi:fused", "smi:static")}
    params = arts["smi:fused"]["init_params"](seed)
    batches = _train_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, 4, seed)
    want_d = 4 * _d_launches(cfg, TP)
    first, launches = {}, {}
    for w, art in arts.items():
        reset_counts()
        loss, _, grads = art["grads"](params, batches[0])
        torch.cuda.synchronize()
        launches[w] = dict(D=matmul.launches, E=flash_attention_kernel.launches,
                           A=dict(fold=fused_accumulate.launches,
                                  shift=fused_shift_accumulate.launches))
        first[w] = (loss, grads)
    _finite_nonzero(first["smi:fused"][1], "train P=8")
    for w, c in launches.items():
        a = c["A"]["fold"] + c["A"]["shift"]
        if c["D"] != want_d or c["E"] != 2 * TRAIN_LAYERS or (a > 0) != (w == "smi:fused"):
            raise AssertionError(f"train P=8 over {w}: launches {c}, want D {want_d}, E "
                                 f"{2 * TRAIN_LAYERS}, A on smi:fused only")
    (lf, gf), (ls, gs) = first["smi:fused"], first["smi:static"]
    if not same_bits(lf.reshape(1), ls.reshape(1)) or not all(same_bits(a, b) for a, b in
                                        zip(tree_flatten(gf), tree_flatten(gs), strict=True)):
        raise AssertionError("train P=8: smi:fused's loss or gradients differ from smi:static's")
    log(f"train P=8: loss {float(lf):.6f} and every gradient bit-equal over smi:fused and "
        f"smi:static; launches a step {launches}")
    del first, gf, gs
    state = {"params": params, "opt": adamw_init(params)}
    state_bytes = sum(t.nbytes for t in tree_flatten(state))
    order = ("smi:static", "smi:fused", "smi:fused", "smi:static")
    turns = {w: [] for w in arts}
    torch.cuda.reset_peak_memory_stats()
    for w, b in zip(order, batches):
        turns[w].append(_timed_ms(lambda: arts[w]["step"](state, b))[1])
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = {w: sum(v) / len(v) for w, v in turns.items()}
    prof = _train_profile(arts["smi:fused"], state, batches[0])
    tokens = TRAIN_SEQ * TRAIN_BATCH
    log(f"train P=8: ms a step {ms} (in turns {turns}); {tokens / ms['smi:fused'] * 1e3:.1f} "
        f"tok/s over smi:fused")
    log(f"train P=8 profile (smi:fused): device {prof['device_ms']:.3f} ms of "
        f"{prof['profiled_wall_ms']:.3f} ms wall (idle {prof['device_idle_share']:.1%}): " +
        ", ".join(f"{k} {v:.3f} ({v / prof['device_ms']:.1%})"
                  for k, v in prof["device_split_ms"].items()))
    del state, params
    gc.collect()
    torch.cuda.empty_cache()

    # float32 against tp = 1
    cfg32 = _train_cfg(TRAIN_ARCH, TRAIN_F32_LAYERS, dtype="float32")
    shape32 = ShapeConfig("train_f32", TRAIN_F32_SEQ, TRAIN_BATCH, "train")
    a1 = build_train(cfg32, shape32, _train_settings(), device=dev)
    a8 = build_train(cfg32, shape32, _train_settings(), mesh=(1, TP), matmul_fn=matmul,
                     device=dev)
    p1, p8 = a1["init_params"](seed), a8["init_params"](seed)
    specs = lm_specs(cfg32, a8["ctx"])
    with torch.no_grad():
        if not all(same_bits(a, b) for a, b in zip(tree_flatten(p1), tree_flatten(
                unshard_tree(p8, specs, a8["ctx"])))):
            raise AssertionError("train f32: the P = 8 params are not tp = 1's, sharded")
    batch = _train_batches(cfg32, TRAIN_F32_SEQ, TRAIN_BATCH, 1, seed)[0]
    l1, _, g1 = a1["grads"](p1, batch)
    l8, _, g8 = a8["grads"](p8, batch)
    g8 = unshard_tree(g8, specs, a8["ctx"])
    loss_err = abs(float(l1) - float(l8))
    grad_err = max(float(((a - b).abs() - TRAIN_F32_TOL * b.abs()).max())
                   for a, b in zip(tree_flatten(g8), tree_flatten(g1)))
    del g1, g8
    s1 = {"params": p1, "opt": adamw_init(p1)}
    s8 = {"params": p8, "opt": adamw_init(p8)}
    a1["step"](s1, batch)
    a8["step"](s8, batch)
    with torch.no_grad():
        p8g = unshard_tree(s8["params"], specs, a8["ctx"])
    param_err = max(float(((a.detach() - b.detach()).abs() - TRAIN_F32_TOL * b.abs()).max())
                    for a, b in zip(tree_flatten(p8g), tree_flatten(s1["params"])))
    log(f"train f32 ({TRAIN_F32_LAYERS} layers, {TRAIN_BATCH} x {TRAIN_F32_SEQ} tokens): P = 8 "
        f"against tp = 1: loss {float(l8):.7f} vs {float(l1):.7f} (|diff| {loss_err:.3e}); "
        f"gradients' excess over {TRAIN_F32_TOL} rtol {grad_err:.3e}, one AdamW step's params' "
        f"{param_err:.3e} (atol {TRAIN_F32_TOL})")
    if loss_err > TRAIN_F32_LOSS_TOL or grad_err > TRAIN_F32_TOL or param_err > TRAIN_F32_TOL:
        raise AssertionError("train f32: P = 8 disagrees with tp = 1")
    del s1, s8, p1, p8, p8g
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ms_per_step=ms, turns=turns, tok_per_s=tokens / ms["smi:fused"] * 1e3,
                launches=launches, peak_gb=peak, state_bytes=state_bytes,
                f32_loss_err=loss_err, f32_grad_excess=grad_err,
                f32_param_excess=param_err, **prof), launches["smi:fused"]


def phase_train_ssm(dev, seed: int = 46) -> tuple[dict, int]:
    """Phase 46: mamba2-2.7b trained at tp = 1 on 2 x 4096 tokens a step.
    Against every kernel off, the first step's per-leaf gradient cosine at
    :data:`SSM_F32_LAYERS` layers and full width: gated at
    :data:`TRAIN_GRAD_COS` in float32 (F on its FMA kernel), reported in
    bfloat16 (F on wgmma; the model's bfloat16 rounding grows over depth,
    ROADMAP.md §3).  Then at full width and :data:`SSM_TRAIN_LAYERS`
    layers in bfloat16: F launched in every layer's forward and remat
    recompute through its Function, every leaf's gradient finite and
    non-zero, :data:`SSM_TRAIN_STEPS` steps timed, the device time by part
    and the peak memory."""
    import torch

    from repro_torch.models.common import tree_flatten
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels.ssd import ssd_scan_kernel
    from repro_torch.launch.steps import build_train
    from repro_torch.models.common import tree_leaves_with_path
    from repro_torch.optim import adamw_init

    shape = ShapeConfig("train_4k_cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    res = {}
    for dtype, layers in (("float32", SSM_F32_LAYERS), ("bfloat16", SSM_F32_LAYERS),
                          ("bfloat16", SSM_TRAIN_LAYERS)):
        key = f"{dtype}_{layers}"
        cfg = _train_cfg(SSM_ARCH, layers, dtype=dtype)
        art = build_train(cfg, shape, _train_settings(), device=dev)
        params = art["init_params"](seed)
        n = sum(t.numel() for t in tree_flatten(params))
        batches = _train_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, SSM_TRAIN_STEPS, seed)
        reset_counts()
        loss, _, grads = art["grads"](params, batches[0])
        torch.cuda.synchronize()
        f, f_wg = ssd_scan_kernel.launches, ssd_scan_kernel.wgmma_launches
        if f != 2 * layers or f_wg != (f if dtype == "bfloat16" else 0):
            raise AssertionError(f"train mamba2 {key}: F launched {f} times ({f_wg} on wgmma), "
                                 f"not {2 * layers}")
        _finite_nonzero(grads, f"train mamba2 {key}")
        res[key] = dict(params=n, layers=layers, loss_first=float(loss), launches_f=f)
        if layers == SSM_F32_LAYERS:
            loss_p, _, grads_p = art["grads"](params, batches[0], use_kernel=False)
            cos = _leaf_cosines(grads, grads_p)
            names = [".".join(map(str, p)) for p, _ in tree_leaves_with_path(grads)]
            worst = sorted(zip(cos, names))[:3]
            del grads, grads_p, params
            log(f"train mamba2 {dtype}, {layers} layers: loss {float(loss):.6f} (kernels off "
                f"{float(loss_p):.6f}); F {f} launches ({f_wg} on wgmma); gradient cosine "
                f"against kernels off, lowest: " + ", ".join(f"{nm} {c:.6f}" for c, nm in worst))
            res[key].update(loss_plain=float(loss_p), min_grad_cos_vs_plain=min(cos),
                            lowest_cos=[(nm, c) for c, nm in worst])
            if dtype == "float32" and min(cos) < TRAIN_GRAD_COS:
                raise AssertionError(f"train mamba2 float32: gradient cosine {min(cos)} < "
                                     f"{TRAIN_GRAD_COS}")
            gc.collect()
            torch.cuda.empty_cache()
            continue
        del grads
        state = {"params": params, "opt": adamw_init(params)}
        res[key]["state_bytes"] = sum(t.nbytes for t in tree_flatten(state))
        torch.cuda.reset_peak_memory_stats()
        ms = [_timed_ms(lambda: art["step"](state, b))[1] for b in batches[:SSM_TRAIN_STEPS - 1]]
        prof = _train_profile(art, state, batches[SSM_TRAIN_STEPS - 1])
        peak = torch.cuda.max_memory_allocated() / 1e9
        tokens = TRAIN_SEQ * TRAIN_BATCH
        log(f"train mamba2 {layers} layers ({n} params, {n * 16 / 1e9:.1f} GB of state): loss "
            f"{float(loss):.6f}, F {f} launches ({f_wg} on wgmma), every gradient finite and "
            f"non-zero; steps {[f'{t:.3f}' for t in ms]} ms ({tokens / ms[-1] * 1e3:.1f} "
            f"tok/s); peak {peak:.2f} GB; profile: device {prof['device_ms']:.3f} ms of "
            f"{prof['profiled_wall_ms']:.3f} ms wall (idle {prof['device_idle_share']:.1%}): " +
            ", ".join(f"{k} {v:.3f} ({v / prof['device_ms']:.1%})"
                      for k, v in prof["device_split_ms"].items()))
        res[key].update(ms_per_step=ms, tok_per_s=tokens / ms[-1] * 1e3, peak_gb=peak, **prof)
        del state, params
        gc.collect()
        torch.cuda.empty_cache()
    return res, res[f"bfloat16_{SSM_TRAIN_LAYERS}"]["launches_f"]


def phase_train_launcher() -> dict:
    """Phase 47: ``python -m repro_torch.launch.train`` for yi-6b at phase
    44's cut and batch (``--layers 8 --seq-len 4096 --batch 2``), run in
    this process: 2 steps through ``build_train`` and ``train_loop`` at tp
    = 1 and at ``--mesh 1,8`` over ``smi:fused`` (D on the GEMMs), each
    exiting 0 with a finite loss logged a step; then ``--validate-comm`` at
    ``1,8`` over ``smi:fused``: one step under a ledger capture, every tag
    equal to ``predict_train_step_stats(eager=True)``."""
    import contextlib
    import io
    import math

    import torch

    from repro_torch.launch import train as launch_train

    base = ["--arch", TRAIN_ARCH, "--layers", str(TRAIN_LAYERS), "--seq-len", str(TRAIN_SEQ),
            "--batch", str(TRAIN_BATCH)]
    res = {}
    for name, args in (("tp1", ["--steps", "2", "--mesh", "1,1"]),
                       (f"p{TP}", ["--steps", "2", "--mesh", f"1,{TP}", "--comm-mode",
                                   "smi:fused"]),
                       ("validate", ["--mesh", f"1,{TP}", "--comm-mode", "smi:fused",
                                     "--validate-comm"])):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = launch_train.main(base + args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        secs = time.perf_counter() - t0
        text = out.getvalue()
        for line in text.splitlines():
            log(f"train launcher {name}: {line}")
        if rc != 0:
            raise AssertionError(f"launch.train {' '.join(args)} exited {rc}")
        if name == "validate":
            res[name] = dict(seconds=secs, tags=sum(1 for line in text.splitlines()
                                                    if line.rstrip().endswith("ok")))
            continue
        losses = [float(line.split("loss=")[1].split()[0]) for line in text.splitlines()
                  if line.startswith("[train] step=")]
        if len(losses) != 2 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"launch.train {' '.join(args)} logged losses {losses}")
        res[name] = dict(seconds=secs, losses=losses)
    return res


# ----------------------------------------------------------- the data axis
#
# Phases 48-52 (slice 12): training over a (data, model) mesh of (2, 4) with
# FSDP and the gradient sync over the "dp" ring, the remat policies that
# save the products, GPipe over a chain channel, and the launchers at 2,4.

DP_MESH = (2, 4)
#: mamba2-2.7b's depth at (2, 4), and the steps a run of each gradient
#: wire (three: step 0's learning rate is 0, so the third loss is the first
#: to follow an update)
SSM_DP_LAYERS = 16
DP_STEPS = 3
#: the GPipe phase: stages, microbatches and each microbatch's (rows, width)
PIPE_STAGES = 8
PIPE_MICRO = 16
PIPE_ROWS, PIPE_WIDTH = 512, 4096
#: phase 52's qwen3-moe serving cut and its decode
FSDP_SERVE_LAYERS = 12


def _grad_ring_a(record: list):
    """A context that wraps ``mesh.api.grad_sync`` (the ``"grad"`` ring) to
    count kernel A's launches inside it into ``record``, and re-runs each of
    A's gather-fused steps there against its plain version (bit for bit):
    the ring's operands are the chunks of the leaves stored whole, float32,
    their lengths the leaves' over the data ranks."""
    import contextlib
    from unittest import mock

    from repro_torch.mesh import api
    from repro_torch.transport import fused

    orig_sync, orig_step = api.grad_sync, fused.FusedTransport.shift_accumulate

    def checked(self, x, addend, comm, step: int = 1):
        out = orig_step(self, x, addend, comm, step)
        src = fused.source_index(tuple(comm.ring_perm(step)), x.shape[0], x.device)
        want = fused.shift_accumulate_plain(x.contiguous(), addend.contiguous(), src)
        if not same_bits(out, want):
            raise AssertionError(f"grad ring: A's shift_accumulate on {tuple(x.shape)} "
                                 f"{x.dtype} differs from its plain version")
        record.append(("shape", tuple(x.shape)))
        return out

    def sync(*a, **kw):
        before = fused.fused_shift_accumulate.launches + fused.fused_accumulate.launches
        with mock.patch.object(fused.FusedTransport, "shift_accumulate", checked):
            out = orig_sync(*a, **kw)
        record.append(("launches", fused.fused_shift_accumulate.launches +
                       fused.fused_accumulate.launches - before))
        return out

    @contextlib.contextmanager
    def ctx():
        with mock.patch.object(api, "grad_sync", sync):
            yield

    return ctx()


def _dp_profile(art, state, batch) -> dict:
    """One (dp, P) training step under ``torch.profiler``: device ms by
    range (the forward, the FSDP gathers, the remat recompute, E's plain
    backward, the rest of the backward, the gradient sync and the
    optimizer) and the idle share.  The gathers are split out of the
    forward and the recompute they run in (the recompute's run with the
    ledger paused, inside a capture)."""
    import contextlib
    from unittest import mock

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import common
    from repro_torch.launch import steps
    from repro_torch.mesh import api
    from repro_torch.parallel import ledger

    orig_paused, orig_bwd, orig_loss = ledger.paused, common.RecomputeFn.backward, steps.lm_loss
    orig_gather, orig_sync = api.fsdp_gather, steps.grad_sync_fsdp
    in_recompute = []

    @contextlib.contextmanager
    def paused():
        in_recompute.append(1)
        try:
            with record_function("recompute"), orig_paused():
                yield
        finally:
            in_recompute.pop()

    def backward(ctx, g):
        with record_function("E plain backward"):
            return orig_bwd(ctx, g)

    def forward(*a, **kw):
        with record_function("forward"):
            return orig_loss(*a, **kw)

    def gather(*a, **kw):
        with record_function("gather recompute" if in_recompute else "gather forward"):
            return orig_gather(*a, **kw)

    def sync(*a, **kw):
        with record_function("gradient sync"):
            return orig_sync(*a, **kw)

    names = ("step", "forward", "recompute", "E plain backward", "gather forward",
             "gather recompute", "gradient sync")
    with mock.patch.object(ledger, "paused", paused), \
            mock.patch.object(common.RecomputeFn, "backward", staticmethod(backward)), \
            mock.patch.object(steps, "lm_loss", forward), \
            mock.patch.object(api, "fsdp_gather", gather), \
            mock.patch.object(steps, "grad_sync_fsdp", sync), ledger.capture():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function("step"):
                art["step"](state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    part = {n: 0.0 for n in names}
    busy = 0.0
    for e in prof.key_averages():
        if e.key in part:
            if e.device_type == DeviceType.CPU:
                part[e.key] += e.device_time_total / 1e3
        elif e.device_type == DeviceType.CUDA:
            busy += e.self_device_time_total / 1e3
    # ranges on autograd's thread (the recompute and E's backward) and on the
    # calling thread (the step, its forward, the sync) do not nest across
    split = {"forward": part["forward"] - part["gather forward"],
             "FSDP gather": part["gather forward"] + part["gather recompute"],
             "recompute": part["recompute"] - part["gather recompute"],
             "E plain backward": part["E plain backward"],
             "gradient sync": part["gradient sync"],
             "optimizer": part["step"] - part["forward"] - part["gradient sync"]}
    split["backward, the rest"] = busy - sum(split.values())
    return dict(device_ms=busy, profiled_wall_ms=wall, device_idle_share=1 - busy / wall,
                device_split_ms=split)


def _dp_f32_check(arch: str, layers: int, seed: int, dev) -> dict:
    """``arch`` in float32 at ``layers`` layers and 2 x :data:`TRAIN_F32_SEQ`
    tokens on :data:`DP_MESH` against the port's ``(1, 4)`` run on the whole
    batch: the loss within :data:`TRAIN_F32_LOSS_TOL`, every unsharded
    gradient within :data:`TRAIN_F32_TOL` rtol/atol, and one AdamW step's
    params too, with the leaf and the two gradients at its worst element
    reported.  AdamW's first step moves an element by less than ``lr``
    times its gradient's sign, so where the gradient lies within the
    gradient tolerance of 0 on both meshes with opposite signs (a
    cancelling sum whose two float32 orders differ in sign) the two steps
    legitimately land up to ``2 lr`` apart: those elements (counted) are
    held within the tolerance plus ``2 lr``, every other within the
    tolerance."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.interop import unshard_params
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.steps import build_train
    from repro_torch.models.common import tree_flatten, tree_leaves_with_path
    from repro_torch.optim import adamw_init

    cfg32 = _train_cfg(arch, layers, dtype="float32")
    shape32 = ShapeConfig("train_f32", TRAIN_F32_SEQ, TRAIN_BATCH, "train")
    tp = DP_MESH[1]
    a1 = build_train(cfg32, shape32, _train_settings(), mesh=(1, tp), matmul_fn=matmul,
                     device=dev)
    a2 = build_train(cfg32, shape32, _train_settings(), mesh=DP_MESH, matmul_fn=matmul,
                     device=dev)
    p1, p2 = a1["init_params"](seed), a2["init_params"](seed)
    with torch.no_grad():
        if not all(same_bits(a, b) for a, b in zip(tree_flatten(unshard_params(
                p1, cfg32, a1["ctx"])), tree_flatten(unshard_params(p2, cfg32, a2["ctx"],
                                                                    a2["plan"])))):
            raise AssertionError(f"{arch} f32: the (2, 4) params are not (1, 4)'s, stored")
    batch = _train_batches(cfg32, TRAIN_F32_SEQ, TRAIN_BATCH, 1, seed)[0]
    l1, _, g1 = a1["grads"](p1, batch)
    l2, _, g2 = a2["grads"](p2, batch)
    g1 = unshard_params(g1, cfg32, a1["ctx"])
    g2 = unshard_params(g2, cfg32, a2["ctx"], a2["plan"])
    loss_err = abs(float(l1) - float(l2))
    grad_err = max(float(((a - b).abs() - TRAIN_F32_TOL * b.abs()).max())
                   for a, b in zip(tree_flatten(g2), tree_flatten(g1)))
    # on the host for the worst element's report: the AdamW steps below hold
    # two float32 copies of the state on the card
    flat1, flat2 = ([t.cpu() for t in tree_flatten(g)] for g in (g1, g2))
    del g1, g2
    s1 = {"params": p1, "opt": adamw_init(p1)}
    s2 = {"params": p2, "opt": adamw_init(p2)}
    a1["step"](s1, batch)
    a2["step"](s2, batch)
    with torch.no_grad():
        q1 = unshard_params(s1["params"], cfg32, a1["ctx"])
        q2 = unshard_params(s2["params"], cfg32, a2["ctx"], a2["plan"])
        flips = [((a.abs() <= TRAIN_F32_TOL) & (b.abs() <= TRAIN_F32_TOL)
                  & (a.sign() != b.sign())).to(dev) for a, b in zip(flat2, flat1)]
        lr2 = 2 * _train_settings().base_lr
        excess = [(a - b).abs() - TRAIN_F32_TOL * b.abs() - lr2 * f
                  for a, b, f in zip(tree_flatten(q2), tree_flatten(q1), flips)]
        n_flips = sum(int(f.sum()) for f in flips)
        param_err = max(float(e.max()) for e in excess)
        k = max(range(len(excess)), key=lambda i: float(excess[i].max()))
        at = int(excess[k].argmax())
        names = [".".join(map(str, p)) for p, _ in tree_leaves_with_path(q1)]
        worst = dict(leaf=names[k], grad_1x4=float(flat1[k].reshape(-1)[at]),
                     grad_2x4=float(flat2[k].reshape(-1)[at]))
    log(f"train {arch} f32 ({layers} layers, {TRAIN_BATCH} x {TRAIN_F32_SEQ} tokens): (2, 4) "
        f"against (1, 4) on the whole batch: loss {float(l2):.7f} vs {float(l1):.7f} (|diff| "
        f"{loss_err:.3e}); gradients' excess over {TRAIN_F32_TOL} rtol {grad_err:.3e}, one "
        f"AdamW step's params' {param_err:.3e} (worst at {worst}; {n_flips} elements whose "
        f"gradients lie within {TRAIN_F32_TOL} of 0 with opposite signs held {lr2} wider)")
    if loss_err > TRAIN_F32_LOSS_TOL or grad_err > TRAIN_F32_TOL or param_err > TRAIN_F32_TOL:
        raise AssertionError(f"train {arch} f32: (2, 4) disagrees with (1, 4)")
    del s1, s2, p1, p2, q1, q2, flat1, flat2, flips, excess
    gc.collect()
    torch.cuda.empty_cache()
    return dict(f32_loss_err=loss_err, f32_grad_excess=grad_err, f32_param_excess=param_err,
                f32_param_worst=worst, f32_step_sign_flips=n_flips)


def phase_train_dp(dev, seed: int = 48) -> tuple[dict, dict]:
    """Phase 48: yi-6b at phase 44's cut (8 layers, full width, 2 x 4096
    tokens: one sequence a data group) on a (2, 4) mesh, FSDP over the data
    axis, D on the tensor-parallel GEMMs, ``remat="nothing"``: the first
    step's loss and gradients bit-equal over ``smi:fused`` and
    ``smi:static`` (A on the fused wire only), E launched twice a layer a
    group; 2 steps a wire timed in turns, the device time by range, the
    idle share and the peak memory; then the float32 check against (1, 4)
    on the whole batch (:func:`_dp_f32_check`)."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.steps import build_train
    from repro_torch.models.common import tree_flatten
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import ledger
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    cfg = _train_cfg(TRAIN_ARCH, TRAIN_LAYERS)
    shape = ShapeConfig("train_4k_cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    arts = {w: build_train(cfg, shape, _train_settings(w), mesh=DP_MESH, matmul_fn=matmul,
                           device=dev) for w in ("smi:fused", "smi:static")}
    dp = DP_MESH[0]
    if arts["smi:fused"]["plan"] is None:
        raise AssertionError("train (2, 4): FSDP is off")
    torch.cuda.reset_peak_memory_stats()
    params = arts["smi:fused"]["init_params"](seed)
    n = sum(t.numel() for t in tree_flatten(params))
    order = ("smi:static", "smi:fused", "smi:fused", "smi:static")   # 2 steps a wire
    batches = _train_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, len(order) + 1, seed)
    first, launches, tags = {}, {}, {}
    for w, art in arts.items():
        reset_counts()
        with ledger.capture() as led:
            loss, _, g = art["grads"](params, batches[0])
        torch.cuda.synchronize()
        launches[w] = dict(D=matmul.launches, E=flash_attention_kernel.launches,
                           A=dict(fold=fused_accumulate.launches,
                                  shift=fused_shift_accumulate.launches))
        tags[w] = {t: dict(e) for t, e in led.by_tag.items()}
        first[w] = (loss, g)
        del g
    _finite_nonzero(first["smi:fused"][1], "train (2, 4)")
    want_d = 4 * _d_launches(cfg, DP_MESH[1]) * dp
    for w, c in launches.items():
        a = c["A"]["fold"] + c["A"]["shift"]
        if c["D"] != want_d or c["E"] != 2 * TRAIN_LAYERS * dp or (a > 0) != (w == "smi:fused"):
            raise AssertionError(f"train (2, 4) over {w}: launches {c}, want D {want_d}, E "
                                 f"{2 * TRAIN_LAYERS * dp}, A on smi:fused only")
    (lf, gf), (ls, gs) = first["smi:fused"], first["smi:static"]
    if not same_bits(lf.reshape(1), ls.reshape(1)) or not all(same_bits(a, b) for a, b in
                                        zip(tree_flatten(gf), tree_flatten(gs), strict=True)):
        raise AssertionError("train (2, 4): smi:fused's loss or gradients differ from "
                             "smi:static's")
    if "fsdp.gather" not in tags["smi:fused"] or tags["smi:fused"] != tags["smi:static"]:
        raise AssertionError(f"train (2, 4): the ledgers {tags}")
    log(f"train (2, 4): {n} params ({n * 16 / 1e9:.1f} GB of float32 state, FSDP-stored); loss "
        f"{float(lf):.6f} and every gradient bit-equal over smi:fused and smi:static; launches "
        f"a step {launches}; fsdp.gather {tags['smi:fused']['fsdp.gather']}")
    del first, gf, gs
    state = {"params": params, "opt": adamw_init(params)}
    turns = {w: [] for w in arts}
    losses = []
    for w, b in zip(order, batches[1:]):
        (_, m), t = _timed_ms(lambda: arts[w]["step"](state, b))
        turns[w].append(t)
        losses.append(float(m["loss"]))
    ms = {w: sum(v) / len(v) for w, v in turns.items()}
    prof = _dp_profile(arts["smi:fused"], state, batches[-1])
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = TRAIN_SEQ * TRAIN_BATCH
    log(f"train (2, 4): ms a step {ms} (in turns {turns}); {tokens / ms['smi:fused'] * 1e3:.1f} "
        f"tok/s over smi:fused; losses {losses}; peak {peak:.2f} GB")
    log(f"train (2, 4) profile (smi:fused): device {prof['device_ms']:.3f} ms of "
        f"{prof['profiled_wall_ms']:.3f} ms wall (idle {prof['device_idle_share']:.1%}): " +
        ", ".join(f"{k} {v:.3f} ({v / prof['device_ms']:.1%})"
                  for k, v in prof["device_split_ms"].items()))
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    f32 = _dp_f32_check(TRAIN_ARCH, TRAIN_F32_LAYERS, seed, dev)
    return dict(params=n, ms_per_step=ms, turns=turns, tok_per_s=tokens / ms["smi:fused"] * 1e3,
                losses=losses, launches=launches, fsdp_gather=tags["smi:fused"]["fsdp.gather"],
                peak_gb=peak, **prof, **f32), launches["smi:fused"]


def phase_train_dp_ssm(dev, seed: int = 49) -> tuple[dict, dict]:
    """Phase 49: mamba2-2.7b at full width and :data:`SSM_DP_LAYERS` layers
    on (2, 4) over ``smi:fused``, FSDP on: :data:`DP_STEPS` steps with raw
    gradients and :data:`DP_STEPS` with ``compressed_grads``; the ``"grad"``
    ring runs on the leaves stored whole (A launched on its raw folds, each
    launch re-run against its plain version; none on the int8 wire, whose
    sums are float32 adds); F launched twice a layer a group; the int8
    run's losses beside the raw run's; first the ring alone on odd lengths
    (1, 3, 161, 1283 float32 elements over the two data ranks), bit-equal
    over ``smi:fused`` and ``smi:static``; then the float32 check against
    (1, 4) at 4 layers."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.ssd import ssd_scan_kernel
    from repro_torch.launch.steps import build_train
    from repro_torch.mesh.api import make_ctx
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import grad_allreduce, ledger
    from repro_torch.transport.fused import fused_shift_accumulate

    g = torch.Generator(device=dev).manual_seed(seed)
    odd = {}
    for m in (1, 3, 161, 1283):
        x = torch.randn((DP_MESH[0], m), generator=g, device=dev)
        out = {}
        for w in ("smi:fused", "smi:static"):
            comm = make_ctx(DP_MESH, comm_mode=w, device=dev).data_comm
            before = fused_shift_accumulate.launches
            out[w] = grad_allreduce(x, comm)
            odd.setdefault(m, {})[w] = fused_shift_accumulate.launches - before
        if not same_bits(out["smi:fused"], out["smi:static"]) or odd[m]["smi:fused"] == 0:
            raise AssertionError(f"grad ring of {m} elements: fused {odd[m]} launches, or its "
                                 f"sum differs from the static wire's")
    log(f"grad ring on odd lengths: bit-equal over smi:fused and smi:static, A's launches {odd}")

    cfg = _train_cfg(SSM_ARCH, SSM_DP_LAYERS)
    shape = ShapeConfig("train_4k_cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    dp = DP_MESH[0]
    res = {"odd_ring_a_launches": odd}
    params = None
    torch.cuda.reset_peak_memory_stats()
    for name, comp in (("raw", False), ("int8", True)):
        art = build_train(cfg, shape, _train_settings(compressed_grads=comp), mesh=DP_MESH,
                          matmul_fn=matmul, device=dev)
        if params is None:
            params = art["init_params"](seed)
            state = {"params": params, "opt": adamw_init(params)}
            snapshot = [t.detach().clone() for t in _flat(state)]
        else:   # the int8 run starts from the raw run's initial state
            for t, s in zip(_flat(state), snapshot):
                with torch.no_grad():
                    t.copy_(s)
        batches = _train_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, DP_STEPS, seed)
        ring, ms, losses = [], [], []
        for b in batches:
            reset_counts()
            with _grad_ring_a(ring), ledger.capture() as led:
                (_, m), t = _timed_ms(lambda: art["step"](state, b))
            f = ssd_scan_kernel.launches
            if f != 2 * SSM_DP_LAYERS * dp:
                raise AssertionError(f"train mamba2 (2, 4) {name}: F launched {f} times, not "
                                     f"{2 * SSM_DP_LAYERS * dp}")
            ms.append(t)
            losses.append(float(m["loss"]))
        a_ring = sum(v for k, v in ring if k == "launches")
        shapes = sorted({v for k, v in ring if k == "shape"})
        if (a_ring > 0) == comp or "grad" not in led.by_tag:
            raise AssertionError(f"train mamba2 (2, 4) {name}: A launched {a_ring} times on "
                                 f"the grad ring ({led.by_tag.get('grad')})")
        res[name] = dict(ms_per_step=ms, losses=losses, a_launches_grad_ring=a_ring,
                         grad_ring_shapes=shapes, grad=led.by_tag["grad"],
                         fsdp_gather=led.by_tag["fsdp.gather"], launches_f=f)
        log(f"train mamba2 (2, 4) {name} gradients ({SSM_DP_LAYERS} layers): steps "
            f"{[f'{t:.3f}' for t in ms]} ms, losses {losses}; F {f} launches a step; grad "
            f"ring {led.by_tag['grad']}, A {a_ring} launches on it (operands {shapes}, each "
            f"bit-equal to its plain version)")
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, params, snapshot
    gc.collect()
    torch.cuda.empty_cache()
    res.update(_dp_f32_check(SSM_ARCH, TRAIN_F32_LAYERS, seed, dev))
    return res, dict(F=res["raw"]["launches_f"], A_grad_ring=res["raw"]["a_launches_grad_ring"])


def _flat(state):
    from repro_torch.models.common import tree_flatten

    return tree_flatten(state)


def phase_remat(dev, seed: int = 50) -> dict:
    """Phase 50: yi-6b at phase 45's cut and batch at P = 8 with D, one
    step under each of ``"nothing"``, ``"dots"`` and ``"dots_nb"`` from the
    same params: the gradients bit-equal across the three (else within
    phase 45's bfloat16 cosine, the differing leaves named), D's launches
    in the recompute (inside the ledger's paused ranges) 320 under
    ``"nothing"`` and 0 under ``"dots"``; for each, ms of the gradients
    and of a step, the recompute's ms (CUDA events around its paused
    ranges) and the peak memory."""
    import contextlib
    from unittest import mock

    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.steps import build_train
    from repro_torch.models.common import tree_flatten, tree_leaves_with_path
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import ledger

    cfg = _train_cfg(TRAIN_ARCH, TRAIN_LAYERS)
    shape = ShapeConfig("train_4k_cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    batch = _train_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, 1, seed)[0]
    res, differ, base = {}, {}, None
    orig_paused = ledger.paused
    rec = {"D": 0, "events": []}

    @contextlib.contextmanager
    def paused():
        before = matmul.launches
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            with orig_paused():
                yield
        finally:
            end.record()
            rec["events"].append((start, end))
            rec["D"] += matmul.launches - before

    for remat in ("nothing", "dots", "dots_nb"):
        art = build_train(cfg, shape, _train_settings("smi:fused", remat=remat),
                          mesh=(1, TP), matmul_fn=matmul, device=dev)
        params = art["init_params"](seed)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        rec.update(D=0, events=[])
        with mock.patch.object(ledger, "paused", paused):
            (_, _, grads), t = _timed_ms(lambda: art["grads"](params, batch))
        rec_ms = sum(s.elapsed_time(e) for s, e in rec["events"])
        res[remat] = dict(grads_ms=t, d_launches=matmul.launches, d_recompute=rec["D"],
                          recompute_ms=rec_ms, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        if base is None:
            base = grads
            names = [".".join(map(str, p)) for p, _ in tree_leaves_with_path(grads)]
        else:
            bad = [nm for nm, a, b in zip(names, tree_flatten(grads), tree_flatten(base))
                   if not same_bits(a, b)]
            if bad:
                cos = min(_leaf_cosines(grads, base))
                differ[remat] = dict(leaves=bad[:5], n=len(bad), min_cos=cos)
                if cos < TRAIN_GRAD_COS:
                    raise AssertionError(f"remat {remat}: the gradients of {bad[:5]} differ "
                                         f"from 'nothing''s beyond cosine {TRAIN_GRAD_COS} "
                                         f"({cos})")
            del grads
        state = {"params": params, "opt": adamw_init(params)}
        res[remat]["step_ms"] = _timed_ms(lambda: art["step"](state, batch))[1]
        log(f"remat {remat}: gradients {t:.3f} ms (the recompute {rec_ms:.3f}), a step "
            f"{res[remat]['step_ms']:.3f} ms; D {res[remat]['d_launches']} launches, "
            f"{rec['D']} of them in the recompute; peak {res[remat]['peak_gb']:.2f} GB")
        del state, params
    want_rec = _d_launches(cfg, TP)
    if res["nothing"]["d_recompute"] != want_rec or res["dots"]["d_recompute"] != 0:
        raise AssertionError(f"remat: D's recompute launches {res}, want {want_rec} under "
                             f"'nothing' and 0 under 'dots'")
    log("remat: gradients bit-equal across nothing, dots and dots_nb" if not differ else
        f"remat: gradients differ from 'nothing''s at {differ}, within cosine "
        f"{TRAIN_GRAD_COS}")
    res["differ"] = differ
    del base
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_pipeline(dev, seed: int = 51) -> dict:
    """Phase 51: GPipe over a chain channel (``core/pipeline.py``):
    :data:`PIPE_STAGES` stages, :data:`PIPE_MICRO` microbatches of
    (:data:`PIPE_ROWS`, :data:`PIPE_WIDTH`) bfloat16, each stage a
    (4096, 4096) product on kernel D then a GELU.  ``pipeline_loss`` and
    its gradients bit-equal to the same stages run one after another;
    ``pp.stage`` tallies M + P - 1 hops; D launches once a tick in the
    forward, over all the rank-stacked stages at once; ms of the forward
    and of the backward."""
    import torch

    from repro_torch.core import Communicator
    from repro_torch.core.pipeline import pipeline_loss
    from repro_torch.kernels.matmul import matmul
    from repro_torch.parallel import ledger

    g = torch.Generator(device=dev).manual_seed(seed)
    P_, M = PIPE_STAGES, PIPE_MICRO
    W0 = (torch.randn((P_, PIPE_WIDTH, PIPE_WIDTH), generator=g, device=dev)
          * PIPE_WIDTH ** -0.5).bfloat16()
    X = torch.randn((M, PIPE_ROWS, PIPE_WIDTH), generator=g, device=dev).bfloat16()
    Y = torch.randn((M, PIPE_ROWS, PIPE_WIDTH), generator=g, device=dev).bfloat16()
    comm = Communicator.create("pp", (P_,), transport="static", device=dev)

    def stage(w, x):
        return torch.nn.functional.gelu(matmul(x, w))

    def loss_fn(p, t):
        return ((p.float() - t.float()) ** 2).mean()

    W = W0.clone().requires_grad_(True)
    reset_counts()
    torch.cuda.synchronize()
    with ledger.capture() as led:
        (loss, t_fwd) = _timed_ms(lambda: pipeline_loss(stage, loss_fn, W, X, Y, comm))
    d_fwd = matmul.launches
    ((gw,), t_bwd) = _timed_ms(lambda: torch.autograd.grad(loss, (W,)))
    hops = led.by_tag.get("pp.stage", {})
    if d_fwd != M + P_ - 1 or hops != {"steps": M + P_ - 1,
                                       "bytes": (M + P_ - 1) * PIPE_ROWS * PIPE_WIDTH * 2}:
        raise AssertionError(f"pipeline: D {d_fwd} launches in the forward, pp.stage {hops}; "
                             f"want {M + P_ - 1} each")
    Ws = W0.clone().requires_grad_(True)
    per = []
    for m in range(M):
        h = X[m]
        for s in range(P_):
            h = stage(Ws[s:s + 1], h.unsqueeze(0))[0]
        per.append(loss_fn(h, Y[m]))
    seq = torch.stack(per).mean()
    (gs,) = torch.autograd.grad(seq, (Ws,))
    if not same_bits(loss.reshape(1), seq.reshape(1)) or not same_bits(gw, gs):
        raise AssertionError(f"pipeline: loss {float(loss)} vs sequential {float(seq)}, or its "
                             f"gradients differ (max {max_abs_err(gw, gs)})")
    log(f"pipeline ({P_} stages, {M} x ({PIPE_ROWS}, {PIPE_WIDTH}) bf16): loss and gradients "
        f"bit-equal to the stages one after another; forward {t_fwd:.3f} ms ({d_fwd} D "
        f"launches, one a tick), backward {t_bwd:.3f} ms; pp.stage {hops}")
    del W, Ws, gw, gs
    torch.cuda.empty_cache()
    return dict(forward_ms=t_fwd, backward_ms=t_bwd, d_forward=d_fwd, pp_stage=hops,
                loss=float(loss.detach()))


def phase_validate_dp() -> dict:
    """Phase 52: the launchers at ``2,4``.  ``launch.train --validate-comm``
    over ``smi:fused`` with ``--compressed-grads``, yi-6b at phase 44's cut
    and mamba2-2.7b at :data:`SSM_DP_LAYERS` layers, 2 x 4096 tokens: every
    tag, ``fsdp.gather`` and ``grad`` included, equal to
    ``predict_train_step_stats(eager=True)``.  Then qwen3-moe-30b-a3b cut
    to :data:`FSDP_SERVE_LAYERS` layers, served by the launcher's continuous
    runtime (``launch.steps.build_continuous_serve``, the launcher's
    params and prompts) at ``2,4`` over ``smi:static``, ``fsdp=True`` and
    ``fsdp=False`` one after the other (never both held): 2 requests of 4
    new tokens, the tokens equal."""
    import contextlib
    import io

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.steps import build_continuous_serve
    from repro_torch.serving import ContinuousEngine

    res = {}
    for arch, layers in ((TRAIN_ARCH, TRAIN_LAYERS), (SSM_ARCH, SSM_DP_LAYERS)):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = launch_train.main(["--arch", arch, "--layers", str(layers), "--seq-len",
                                    str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--mesh", "2,4",
                                    "--comm-mode", "smi:fused", "--compressed-grads",
                                    "--validate-comm"])
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        text = out.getvalue()
        for line in text.splitlines():
            log(f"train launcher {arch} 2,4: {line}")
        if rc != 0 or "fsdp.gather" not in text:
            raise AssertionError(f"launch.train {arch} --mesh 2,4 --validate-comm exited {rc}")
        res[f"train {arch}"] = dict(seconds=time.perf_counter() - t0, tags=sum(
            1 for line in text.splitlines() if line.rstrip().endswith("ok")))
    cfg = get_arch(MOE_ARCH).scaled(n_layers=FSDP_SERVE_LAYERS)
    dev = torch.device("cuda")
    outs = {}
    for fsdp in (True, False):
        rt = build_continuous_serve(cfg, mesh=(2, 4), comm_mode="smi:static", batch_slots=2,
                                    capacity=64, fsdp=fsdp, device=dev)
        if (rt["plan"] is not None) != fsdp:
            raise AssertionError(f"serve {MOE_ARCH} 2,4 fsdp={fsdp}: plan {rt['plan']}")
        eng = ContinuousEngine(cfg, launch_serve._params(cfg, rt, dev), runtime=rt)
        launch_serve._submit_all(eng, cfg, 2, 4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run(max_steps=1024)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        eng.shutdown()
        if len(done) != 2:
            raise AssertionError(f"serve {MOE_ARCH} 2,4 fsdp={fsdp}: {len(done)} of 2 done")
        outs[fsdp] = {r.uid: r.out for r in done}
        toks = sum(len(r.out) for r in done)
        r = dict(tok_per_s=toks / dt, ms_per_step=dt * 1e3 / max(eng.decode_steps, 1),
                 decode_steps=eng.decode_steps, tokens=toks)
        res[f"serve fsdp {'on' if fsdp else 'off'}"] = r
        log(f"serve {MOE_ARCH} x {FSDP_SERVE_LAYERS} layers 2,4 fsdp={fsdp}: {toks} tokens, "
            f"{r['ms_per_step']:.3f} ms a decode step; {outs[fsdp]}")
        del eng, rt, done
        gc.collect()
        torch.cuda.empty_cache()
    if outs[True] != outs[False]:
        raise AssertionError(f"serve {MOE_ARCH} 2,4: FSDP weights gave {outs[True]}, "
                             f"replicated {outs[False]}")
    log(f"serve {MOE_ARCH} 2,4: tokens equal on FSDP and replicated weights")
    return res

#: the traced stencil runs of phases 53-54 (phase 4's cell, ``--comm-mode``
#: added per wire)
TRACE_STENCIL_ARGS = ["--grid", "2x4", "--domain", "8192x8192", "--steps", "32"]
#: yi-6b served under capture at 16 of its 32 layers
CAPTURE_SERVE_LAYERS = 16


def _trace_doc_checks(doc, events, comm, steps: int, what: str) -> dict:
    """The trace gates of phases 53-54: the document parses back to its
    events, one measured lane a rank (and the host lane of the channel
    events), one netsim lane a directed link, one ``halo.start`` and one
    ``halo.finish`` a step, and one timed ``run.step`` slice a step on
    every rank."""
    from repro_torch.obs import export

    if export.parse_chrome_trace(json.dumps(doc)) != events:
        raise AssertionError(f"{what}: the trace does not parse back to its events")
    kinds = [e["kind"] for e in events]
    n_links = len(export.directed_links(comm.topology))
    lanes = export.lane_count(doc, export.PID_RANKS)
    sim_lanes = export.lane_count(doc, export.PID_SIM_LINKS)
    ranks = {e["rank"] for e in events if e["kind"] == "run.step"}
    run_steps = [e for e in events if e["kind"] == "run.step"]
    if (lanes != comm.size + 1 or ranks != set(range(comm.size)) or sim_lanes != n_links
            or kinds.count("halo.start") != steps or kinds.count("halo.finish") != steps
            or len(run_steps) != comm.size * steps
            or not all(e["attrs"]["dur"] > 0 for e in run_steps)):
        raise AssertionError(
            f"{what}: {lanes} rank lanes (want {comm.size} + host), {sim_lanes} link lanes "
            f"(want {n_links}), halo.start x{kinds.count('halo.start')}, halo.finish "
            f"x{kinds.count('halo.finish')}, run.step x{len(run_steps)} (want {steps} each)")
    return {k: kinds.count(k) for k in sorted(set(kinds))}


def phase_traced_stencil(dev, comm_mode: str, halo_per_rank: tuple) -> dict:
    """Phases 53 (``smi:fused``) and 54 (``smi:packet``):
    ``launch.stencil`` at phase 4's cell with ``--trace --metrics``, run in
    turns with the same command untraced (untraced, traced, traced,
    untraced).  Gates, on every run: the result bit-equal to the
    single-rank sweep and, traced, the traced steps' result bit-equal to
    the untraced run's (the launcher's ``ok``); kernel B launched (and C,
    on its warp path, over the packet wire); the trace as
    :func:`_trace_doc_checks` says; the metrics snapshot's ``halo`` steps
    and bytes equal to the launcher's own and to ``halo_per_rank`` (phase
    4's, or phase 10's on the packet wire); over the packet wire the four
    ``router.*`` events present and the snapshot's overflow 0.  Prints the
    wall a step of both modes."""
    import torch

    from repro_torch.apps import DistributedStencil
    from repro_torch.kernels.router import router_run
    from repro_torch.kernels.stencil import stencil_sweep
    from repro_torch.launch import stencil as launch_stencil
    from repro_torch.obs import export
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    comm = DistributedStencil.create((2, 4), device=dev).comm
    steps = int(TRACE_STENCIL_ARGS[-1])
    packet = comm_mode == "smi:packet"
    walls = {"untraced": [], "traced": []}
    res = {"comm_mode": comm_mode}
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        for i, mode in enumerate(("untraced", "traced", "traced", "untraced")):
            out = os.path.join(tmp, f"{i}.json")
            argv = [*TRACE_STENCIL_ARGS, "--comm-mode", comm_mode, "--json", out]
            if mode == "traced":
                argv += ["--trace", os.path.join(tmp, f"{i}.trace.json"),
                         "--metrics", os.path.join(tmp, f"{i}.metrics.json")]
            rc = launch_stencil.main(argv)
            torch.cuda.synchronize()
            run = json.loads(Path(out).read_text())
            if rc != 0 or not run["ok"] or run["max_err"] != 0.0:
                raise AssertionError(f"{comm_mode} {mode} stencil: rc={rc} result={run}")
            walls[mode].append(run["wall_per_step_s"] * 1e3)
            own = (run["halo_steps"], run["halo_bytes_per_rank"])
            if own != tuple(halo_per_rank):
                raise AssertionError(f"{comm_mode} {mode} stencil: halo {own}, phase 4/10 "
                                     f"gave {tuple(halo_per_rank)} per rank")
            if mode == "untraced":
                continue
            doc = json.loads(Path(argv[argv.index("--trace") + 1]).read_text())
            snap = json.loads(Path(argv[argv.index("--metrics") + 1]).read_text())
            events = export.parse_chrome_trace(doc)
            res["event_counts"] = _trace_doc_checks(doc, events, comm, steps,
                                                    f"{comm_mode} traced stencil")
            halo = snap["transports"]["halo"]
            if (halo["steps"], halo["bytes"]) != own or \
                    halo["by_tag"]["halo"] != {"steps": own[0], "bytes": own[1]}:
                raise AssertionError(f"{comm_mode}: the snapshot's halo {halo} is not the "
                                     f"launcher's {own}")
            res["snapshot_halo"] = halo
            res["drift_wall_vs_model"] = snap["gauges"]["drift/stencil/wall_vs_model"]
            if packet:
                kinds = set(res["event_counts"])
                want = {"router.run", "router.tick_batch", "router.drain", "router.overflow"}
                if not want <= kinds or halo["overflow"] != 0:
                    raise AssertionError(f"packet traced stencil: events {sorted(kinds)}, "
                                         f"overflow {halo['overflow']}")
        launches = {"B": stencil_sweep.launches, "C": router_run.launches,
                    "C_warp": router_run.warp_launches, "A_fold": fused_accumulate.launches,
                    "A_shift": fused_shift_accumulate.launches}
    if launches["B"] == 0 or (packet and (launches["C"] == 0
                                          or launches["C_warp"] != launches["C"])):
        raise AssertionError(f"{comm_mode} traced stencil launched {launches}")
    res["launches"] = launches
    res["wall_per_step_ms"] = {k: sum(v) / len(v) for k, v in walls.items()}
    res["turns_ms"] = walls
    w = res["wall_per_step_ms"]
    log(f"traced stencil over {comm_mode}: {w['traced']:.4f} ms/step traced, "
        f"{w['untraced']:.4f} untraced (turns {walls}); events {res['event_counts']}; "
        f"launches {launches} over the four runs; snapshot halo {res['snapshot_halo']}; "
        f"drift wall/model {res['drift_wall_vs_model']:.3f}")
    return res


def phase_traced_allreduce(dev) -> dict:
    """Phase 53, second part: kernel A under the tracer.  The halo exchange
    moves its slabs by index copies on every wire (there is no fold in it to
    fuse), so the traced stencil over ``smi:fused`` launches no A; the fused
    wire's A runs in reductions.  An all-reduce channel over ``smi:fused``
    of the stencil's state (8 x 4096 x 2048 float32) runs traced: A
    launched gather-fused once a reduce-scatter ring step, the channel's
    open, transfer start and finish events present, the result bit-equal to
    the same transfer over ``smi:static``."""
    import torch

    from repro_torch.channels import open_allreduce_channel
    from repro_torch.core import Communicator
    from repro_torch.obs import trace as obs_trace
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    comm = Communicator.create(("x", "y"), DIMS, device=dev)
    g = torch.Generator(device=dev).manual_seed(53)
    x = torch.randn((P, 4096, 2048), generator=g, device=dev)
    reset_counts()
    with obs_trace.enabled() as tr:
        got = open_allreduce_channel(comm, port=None, tag="traced.allreduce",
                                     transport="fused").transfer(x)
    torch.cuda.synchronize()
    launched = {"fold": fused_accumulate.launches, "shift": fused_shift_accumulate.launches}
    want = open_allreduce_channel(comm, port=None, transport="static").transfer(x)
    torch.cuda.synchronize()
    kinds = [e["kind"] for e in tr.events()]
    if not same_bits(got, want) or launched["shift"] != P - 1 or kinds != [
            "channel.open", "channel.transfer.start", "channel.transfer.finish"]:
        raise AssertionError(f"traced all-reduce over smi:fused: equal={same_bits(got, want)}, "
                             f"A {launched}, events {kinds}")
    log(f"traced all-reduce channel over smi:fused: A launched {launched['shift']} times "
        f"gather-fused, events {kinds}, bit-equal to smi:static")
    return {"launches": launched, "events": kinds}


def phase_lint_capture(dev) -> dict:
    """Phase 55: smilint.  ``python -m repro_torch.analysis.lint --json``
    runs its three passes, the capture pass's programs on the card (the
    reference's smoke sizes): exit 0, no diagnostic, every capture's real
    steps 0, every corpus case its golden ids.  Then yi-6b at full width,
    cut to :data:`CAPTURE_SERVE_LAYERS` layers, served at P = 8 over
    ``smi:static`` by the continuous runtime (4 requests, 8 new tokens),
    the decode step and a slot migration captured on the same params
    (``analysis.programs.capture_serve``: every collective the abstract
    backend's zeros, the compute on the card), and served again: zero
    diagnostics, zero real steps, the tokens after the capture equal to
    those before it."""
    import contextlib
    import io

    import torch

    from repro_torch.analysis import lint, programs
    from repro_torch.analysis.verify import verify_ledger
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.steps import build_continuous_serve
    from repro_torch.serving import ContinuousEngine
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        report_path = os.path.join(tmp, "smilint.json")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = lint.main(["--root", str(ROOT), "--json", report_path, "--device", dev.type])
        torch.cuda.synchronize()
        res["lint_s"] = time.perf_counter() - t0
        for line in out.getvalue().splitlines():
            log(f"smilint: {line}")
        report = json.loads(Path(report_path).read_text())
    rows = report["capture"]["programs"]
    if rc != 0 or not report["ok"] or report["ast"]["diagnostics"] or \
            any(r["real_steps"] or r["diagnostics"] for r in rows) or \
            not all(r["ok"] for r in report["corpus"]["corpus"]):
        raise AssertionError(f"smilint exited {rc}: {json.dumps(report)[:2000]}")
    res["programs"] = {r["program"]: {"ops": sum(r["ops"].values()),
                                      "real_steps": r["real_steps"]} for r in rows}

    cfg = get_arch("yi-6b").scaled(n_layers=CAPTURE_SERVE_LAYERS)
    mesh = (1, TP)

    def serve(params):
        rt = build_continuous_serve(cfg, mesh=mesh, comm_mode="smi:static", device=dev)
        if params is None:
            params = launch_serve._params(cfg, rt, dev)
        eng = ContinuousEngine(cfg, params, runtime=rt)
        launch_serve._submit_all(eng, cfg, 4, 8)
        done = eng.run(max_steps=256)
        torch.cuda.synchronize()
        eng.shutdown()
        if len(done) != 4:
            raise AssertionError(f"capture phase: {len(done)} of 4 requests served")
        return params, {r.uid: r.out for r in done}

    params, before = serve(None)
    reset_counts()
    t0 = time.perf_counter()
    led = programs.capture_serve(mesh, "smi:static", cfg=cfg, params=params, device=dev)
    torch.cuda.synchronize()
    res["capture_s"] = time.perf_counter() - t0
    inside = {"D": matmul.launches, "E": flash_attention_kernel.launches,
              "A_fold": fused_accumulate.launches, "A_shift": fused_shift_accumulate.launches}
    diags = verify_ledger(led, name="yi-6b serve capture")
    _, after = serve(params)
    if diags or led.real_steps != 0 or before != after or not led.transport_steps:
        raise AssertionError(f"yi-6b serve capture: {[str(d) for d in diags]}, real steps "
                             f"{led.real_steps}, tokens before {before} after {after}")
    res["serve_capture"] = {"ops": led.counts(), "real_steps": led.real_steps,
                            "transport_steps": led.transport_steps,
                            "launches_inside": inside, "tokens": before}
    log(f"yi-6b x {CAPTURE_SERVE_LAYERS} layers at P = {TP}: capture of a decode step and a "
        f"migration {led.counts()}, real steps 0, no diagnostic, {res['capture_s']:.1f} s; "
        f"kernel launches inside {inside}; tokens after the capture equal to before {before}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res



# ---------------------------------------------------------------- planning
#
# Phases 56-58 (slice 14): the dry run (``launch/dryrun.py``: every step
# built on the meta device at full width and counted, nothing run) at the
# production meshes and at the cuts phases 13 and 44-46 ran on the card,
# the roofline of each (``launch/roofline.py``), and yi-6b trained over a
# (pod, data, model) mesh.

#: phase 56's cells, (arch, shape, multi-pod), longest first
DRY_CELLS = (
    ("command-r-plus-104b", "train_4k", True),
    ("mamba2-2.7b", "train_4k", False),
    ("qwen3-moe-30b-a3b", "train_4k", False),
    ("yi-6b", "train_4k", False),
    ("yi-6b", "prefill_32k", False),
    ("mamba2-2.7b", "prefill_32k", False),
    ("qwen3-moe-30b-a3b", "prefill_32k", False),
    ("yi-6b", "decode_32k", False),
    ("mamba2-2.7b", "decode_32k", False),
    ("qwen3-moe-30b-a3b", "decode_32k", False),
    ("mamba2-2.7b", "long_500k", True),
)
#: worker processes of the dry run (meta tensors only: host work, one core
#: each; two of the card machine's 8 cores left to the phases beside them),
#: its host budget in seconds, and a card's memory in GB
DRY_WORKERS = 6
DRY_BUDGET_S = 60
DEVICE_GB = 80
#: phase 58: yi-6b over the pod axis, its launcher's arguments and the mesh it
#: is held against (the same rows: every step's loss bit-equal), and the
#: float32 gradient check's tolerance, of each leaf's largest magnitude (the
#: two meshes run the same products in the same order; only the atomic sums
#: of a gather's backward may differ)
POD_MESH = "2,2,2"
POD_FLAT_MESH = "4,2"
POD_LAYERS = 4
POD_BATCH = 4
POD_ARGS = ["--arch", "yi-6b", "--layers", str(POD_LAYERS), "--seq-len", "4096", "--batch",
            str(POD_BATCH), "--steps", "2", "--comm-mode", "smi:fused"]
POD_F32_TOL = 1e-5


def _dry_cuts() -> dict:
    """Phase 57's cuts, each as the phase that ran it on the card: (arch,
    layers, seq, batch, kind, mesh, train comm_mode or None)."""
    return {
        "13": ("yi-6b", 32, PREFILL_TOKENS, 1, "prefill", (1,), None),
        "44": (TRAIN_ARCH, TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, "train", (1,), "smi:fused"),
        "45": (TRAIN_ARCH, TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, "train", (1, TP), "smi:fused"),
        "46": (SSM_ARCH, SSM_TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, "train", (1,), "smi:fused"),
    }


def _cut_of(spec):
    from repro_torch.configs import ShapeConfig

    arch, layers, seq, batch, kind, _mesh, _wire = spec
    return _train_cfg(arch, layers), ShapeConfig(f"{kind}_cut", seq, batch, kind)


def _dry_job(job: tuple) -> dict:
    """One dry-run job, in a worker process (the meta device only):
    ``("cell", arch, shape, multi_pod)`` through ``run_cell``, or ``("cut",
    name, spec)`` (:func:`_dry_cuts`) through ``dry_run``."""
    import torch

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if job[0] == "cell":
        from repro_torch.launch.dryrun import run_cell

        rec = run_cell(job[1], job[2], multi_pod=job[3], verbose=False)
    else:
        from repro_torch.launch.dryrun import dry_run

        name, spec = job[1], job[2]
        cfg, shape = _cut_of(spec)
        wire = spec[6]
        rec = dry_run(cfg, shape, spec[5], settings=_train_settings(wire) if wire else None)
        rec.update(arch=spec[0], shape=shape.name, kind=shape.kind, ok=True,
                   mesh="x".join(map(str, spec[5])))
    rec["host_s"] = time.perf_counter() - t0
    rec["done_at"] = time.time()
    return rec


def start_dryrun():
    """Phase 56's start: the dry run of :data:`DRY_CELLS` at their
    production meshes and of phase 57's cuts submitted to
    :data:`DRY_WORKERS` worker processes (spawned: this process holds the
    card; meta tensors only, so phase 58 runs on the card meanwhile),
    longest first.  Returns what :func:`phase_dryrun` collects."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    jobs = [("cell", *c) for c in DRY_CELLS[:4]] + \
        [("cut", k, v) for k, v in _dry_cuts().items()] + [("cell", *c) for c in DRY_CELLS[4:]]
    pool = ProcessPoolExecutor(max_workers=DRY_WORKERS, mp_context=mp.get_context("spawn"))
    return pool, jobs, [pool.submit(_dry_job, j) for j in jobs], time.time()


def phase_dryrun(started) -> tuple[dict, dict]:
    """Phase 56: the records of :func:`start_dryrun`'s jobs, every one
    ``ok``.  Per cell: the per-device GB (arguments and the peak above
    them), FLOPs and collective bytes, the roofline's dominant term and
    fraction; the cells past :data:`DEVICE_GB` a device named (not gated).
    Returns the cells' records with their roofline rows, and the cuts'
    records."""
    from repro_torch.launch.roofline import analyze_cell

    pool, jobs, futures, t0 = started
    with pool:
        recs = [f.result() for f in futures]
    wall = max(r["done_at"] for r in recs) - t0      # from the start to the last job's end
    bad = [f"{r['arch']} {r['shape']} {r['mesh']}: {r.get('error')}" for r in recs if not r["ok"]]
    if bad:
        raise AssertionError("dry run failed: " + "; ".join(bad))
    cells, cut_recs, over = {}, {}, []
    for job, rec in zip(jobs, recs):
        if job[0] == "cut":
            cut_recs[job[1]] = rec
            continue
        row = analyze_cell(rec)
        gb = (rec["memory_bytes"]["argument"] + rec["memory_bytes"]["temp"]) / 1e9
        if gb > DEVICE_GB:
            over.append(f"{rec['arch']} {rec['shape']} {rec['mesh']} ({gb:.1f} GB)")
        t = row["terms_s"]
        log(f"dry run {rec['arch']} {rec['shape']} {rec['mesh']}: {rec['host_s']:.1f} s host; "
            f"a device {rec['memory']['argument_gb']:.3f} GiB arguments + "
            f"{rec['memory']['temp_gb']:.3f} GiB peak above them ({gb:.2f} GB), "
            f"{rec['cost']['flops']:.4g} FLOPs, {rec['cost']['bytes_accessed']:.4g} B accessed, "
            f"{rec['collectives']['total']:.4g} collective B; compute {t['compute_s']:.4f} s, "
            f"memory {t['memory_s']:.4f} s, collective {t['collective_s']:.4f} s: "
            f"{row['dominant']} dominates, roofline fraction {row['roofline_fraction']:.4f}, "
            f"counted/model FLOPs {row['hlo_over_model_flops']:.3f}")
        cells[f"{rec['arch']} {rec['shape']} {rec['mesh']}"] = dict(
            host_s=rec["host_s"], memory_bytes=rec["memory_bytes"], cost=rec["cost"],
            collective_bytes=rec["collectives"]["total"], terms_s=t, dominant=row["dominant"],
            roofline_fraction=row["roofline_fraction"],
            hlo_over_model_flops=row["hlo_over_model_flops"])
    log(f"dry run: {len(cells)} cells and {len(cut_recs)} cuts ok on {DRY_WORKERS} workers in "
        f"{wall:.1f} s host (budget {DRY_BUDGET_S} s); past {DEVICE_GB} GB a device: "
        f"{', '.join(over) or 'none'}")
    return dict(cells=cells, wall_s=wall, over_device_gb=over), cut_recs


def phase_dry_vs_card(cut_recs: dict, measured: dict) -> dict:
    """Phase 57: each cut's dry run (phase 56's workers) held against what
    its phase measured on the card, not run again: the predicted state
    bytes of the rank stack equal to the ``nbytes`` of the state the phase
    held (params; training: and the AdamW moments and step), exactly; the
    predicted peak (state, inputs and the peak above them) beside
    ``torch.cuda.max_memory_allocated`` and their ratio; the model FLOPs
    over the measured step time as a share of the dense bfloat16 peak (the
    measured roofline fraction) beside the roofline's own fraction.
    ``measured`` maps a cut to ``(state_bytes, peak_bytes, ms)``."""
    from repro_torch.launch.roofline import model_flops_per_device, roofline_row

    out = {}
    for name, spec in _dry_cuts().items():
        rec = cut_recs[name]
        cfg, shape = _cut_of(spec)
        state, peak, ms = measured[name]
        pred_state, pred_peak = rec["stack"]["state_bytes"], rec["stack"]["peak_bytes"]
        if pred_state != state:
            raise AssertionError(f"phase {name}'s cut: the dry run predicts {pred_state} B of "
                                 f"state, the card held {state}")
        row = roofline_row(rec, cfg, shape)
        meas_frac = model_flops_per_device(cfg, shape, 1) / (ms / 1e3) / BF16_OPS_PER_S
        is_bound = meas_frac <= row["roofline_fraction"]
        out[name] = dict(state_bytes=state, predicted_peak_bytes=pred_peak, peak_bytes=peak,
                         peak_ratio=pred_peak / peak, ms=ms, measured_fraction=meas_frac,
                         roofline_fraction=row["roofline_fraction"], roofline_is_bound=is_bound,
                         dominant=row["dominant"],
                         terms_s=row["terms_s"], hlo_over_model_flops=row["hlo_over_model_flops"])
        log(f"phase {name}'s cut ({spec[0]} x {spec[1]} layers, {spec[3]} x {spec[2]} tokens, "
            f"{shape.kind}, mesh {rec['mesh']}): state {state} B predicted exactly; peak "
            f"predicted {pred_peak / 1e9:.3f} GB against {peak / 1e9:.3f} measured (ratio "
            f"{pred_peak / peak:.3f}); {ms:.3f} ms measured: measured roofline fraction "
            f"{meas_frac:.4f} of {BF16_OPS_PER_S:.3g}, the roofline's {row['roofline_fraction']:.4f} "
            f"({row['dominant']} dominates{'' if is_bound else '; the card beat it: not a bound'})")
    return out


def _pod_f32_check(dev, seed: int = 58) -> dict:
    """yi-6b in float32 at :data:`POD_LAYERS` layers and :data:`POD_BATCH` x
    :data:`TRAIN_F32_SEQ` tokens over ``smi:fused`` at ``2,2,2`` against
    ``4,2`` on the same rows: the params stored alike and bit-equal, the
    loss bit-equal, and every gradient leaf as stored (the FSDP blocks
    summed over the pod x data torus, or over the 4-ring) within
    :data:`POD_F32_TOL` of its largest magnitude at ``4,2``, the bit-equal
    leaves counted."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch.steps import build_train
    from repro_torch.models.common import tree_flatten

    cfg32 = _train_cfg("yi-6b", POD_LAYERS, dtype="float32")
    shape32 = ShapeConfig("train_f32", TRAIN_F32_SEQ, POD_BATCH, "train")
    batch = _train_batches(cfg32, TRAIN_F32_SEQ, POD_BATCH, 1, seed)[0]
    got = {}
    for mesh in (POD_MESH, POD_FLAT_MESH):
        art = build_train(cfg32, shape32, _train_settings(), mesh=tuple(map(int, mesh.split(","))),
                          matmul_fn=matmul, device=dev)
        params = art["init_params"](seed)
        loss, _, g = art["grads"](params, batch)
        got[mesh] = (loss, tree_flatten(params), tree_flatten(g))
        del art
    (l_pod, p_pod, g_pod), (l_flat, p_flat, g_flat) = got[POD_MESH], got[POD_FLAT_MESH]
    with torch.no_grad():
        if [t.shape for t in p_pod] != [t.shape for t in p_flat] or \
                not all(same_bits(a, b) for a, b in zip(p_pod, p_flat)):
            raise AssertionError(f"pod axis f32: the params at {POD_MESH} are not stored as at "
                                 f"{POD_FLAT_MESH}")
        errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_pod, g_flat)]
        n_same = sum(same_bits(a, b) for a, b in zip(g_pod, g_flat))
    res = dict(loss=float(l_pod), loss_bit_equal=same_bits(l_pod.reshape(1), l_flat.reshape(1)),
               grad_max_rel_err=max(errs), grad_leaves=len(errs), grad_leaves_bit_equal=n_same)
    log(f"pod axis f32 ({POD_LAYERS} layers, {POD_BATCH} x {TRAIN_F32_SEQ} tokens): loss "
        f"{float(l_pod)!r} at {POD_MESH}, {float(l_flat)!r} at {POD_FLAT_MESH}; gradients "
        f"within {max(errs):.3e} of each leaf's largest magnitude (tolerance {POD_F32_TOL}), "
        f"{n_same} of {len(errs)} leaves bit-equal")
    if not res["loss_bit_equal"] or max(errs) > POD_F32_TOL:
        raise AssertionError(f"pod axis f32: {POD_MESH} disagrees with {POD_FLAT_MESH}: {res}")
    del got, p_pod, p_flat, g_pod, g_flat
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_pod_axis(dev) -> tuple[dict, dict]:
    """Phase 58: ``python -m repro_torch.launch.train`` (run in this process)
    for yi-6b at 4 layers, 4 x 4096 tokens, over ``smi:fused`` at ``--mesh
    2,2,2`` (pod, data, model: FSDP over the pod x data torus) and at ``4,2``,
    2 steps each, then ``--validate-comm`` at ``2,2,2``: every run exits 0,
    every tag equal to netsim's prediction, each step's loss bit-equal to
    ``4,2``'s (the same rows, bfloat16); ms a step of each in turns (2,2,2,
    4,2, and the validated step at 2,2,2), and A's, D's and E's launches a
    step.  Then the gradients in float32 (:func:`_pod_f32_check`).  Returns
    the results and ``2,2,2``'s launches a step."""
    import contextlib
    import io
    from unittest import mock

    import torch

    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch import train as launch_train
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    step_ms, step_loss = [], []
    orig_build = launch_train.build_train

    def timed_build(*a, **kw):
        art = orig_build(*a, **kw)
        orig_step = art["step"]

        def step(*sa, **skw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = orig_step(*sa, **skw)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            step_loss.append(got[1]["loss"].reshape(1).clone())
            return got

        art["step"] = step
        return art

    res, per_step, loss_of = {}, {}, {}
    for name, mesh, extra in (("pod", POD_MESH, []), ("flat", POD_FLAT_MESH, []),
                              ("validate", POD_MESH, ["--validate-comm"])):
        out = io.StringIO()
        step_ms.clear()
        step_loss.clear()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), mock.patch.object(launch_train, "build_train",
                                                                timed_build):
            rc = launch_train.main(POD_ARGS + ["--mesh", mesh] + extra)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        text = out.getvalue()
        for line in text.splitlines():
            log(f"pod axis {name} ({mesh}): {line}")
        if rc != 0 or (name == "validate" and "[validate-comm] ok" not in text):
            raise AssertionError(f"launch.train --mesh {mesh} {' '.join(extra)} exited {rc}")
        n = len(step_ms)
        launches = dict(A=dict(fold=fused_accumulate.launches / n,
                               shift=fused_shift_accumulate.launches / n),
                        D=matmul.launches / n, E=flash_attention_kernel.launches / n)
        per_step[name] = launches
        loss_of[name] = list(step_loss)
        res[name] = dict(seconds=secs, step_ms=list(step_ms),
                         losses=[float(v[0]) for v in step_loss], launches_per_step=launches)
        gc.collect()
        torch.cuda.empty_cache()
    l_pod, l_flat = loss_of["pod"], loss_of["flat"]
    if len(l_pod) != len(l_flat) or not all(same_bits(a, b) for a, b in zip(l_pod, l_flat)):
        raise AssertionError(f"pod axis: the losses {res['pod']['losses']} at {POD_MESH} are "
                             f"not {POD_FLAT_MESH}'s {res['flat']['losses']} bit for bit")
    if per_step["pod"]["E"] <= 0 or per_step["pod"]["D"] <= 0 or \
            per_step["pod"]["A"]["shift"] <= 0:
        raise AssertionError(f"pod axis: a step at {POD_MESH} launched {per_step['pod']}")
    log(f"pod axis: every step's loss {res['pod']['losses']!r} at {POD_MESH} bit-equal to "
        f"{POD_FLAT_MESH}'s; ms a step in turns: {POD_MESH} {res['pod']['step_ms']}, "
        f"{POD_FLAT_MESH} {res['flat']['step_ms']}, {POD_MESH} validated "
        f"{res['validate']['step_ms']}; launches a step {per_step}")
    res["f32"] = _pod_f32_check(dev)
    return res, per_step['pod']


# -- ranks as processes (slice 15) --------------------------------------------------------

#: phase 59: the rank processes of the 8-rank testbed, one a rank, on the card
SPMD_PROCS = 8
SPMD_STEPS = 8
SPMD_DOMAIN = (8192, 8192)
SPMD_STENCIL_ARGS = ["--grid", "2x4", "--domain", "x".join(map(str, SPMD_DOMAIN)), "--steps",
                     str(SPMD_STEPS), "--comm-mode", "smi:static"]
SPMD_REDUCTIONS = ("allreduce", "reduce_scatter")
SPMD_LAYOUTS = {"ring(1x8)": (("x",), (8,)), "torus(2x4)": (("x", "y"), DIMS)}
SPMD_WIRES = ("static", "fused")
SPMD_REPS = 3
#: elements a push/pop loop of phase 59 (c) delivers (phase 21: 64)
SPMD_POPS = 32
#: a slot holds the largest step of the phase: an all-reduce's ring block
SPMD_SLOT_BYTES = REDUCE_ELEMS // P * 4 + (64 << 10)


def _spmd_reduce(name: str, x, comm, t):
    from repro_torch.core.collectives import allreduce, stream_reduce_scatter

    if name == "allreduce":
        return allreduce(x, comm, plan=None, transport=t)
    return stream_reduce_scatter(x, comm, transport=t)


def _spmd_reduce_rank(comm, *, xs, wants, reps: int) -> dict:
    """Phase 59 (b) in a rank process: its rows of ``xs`` (the parent's
    rank-stacked input, mapped from the parent's memory) through each
    reduction of :data:`SPMD_REDUCTIONS` over each wire, held bit for bit
    against its rows of the stacked ``smi:static`` result in ``wants``
    (mapped too); the counters, kernel A's launches, and with ``reps`` the
    stamps around that many timed calls of each."""
    import torch

    from repro_torch.core.spmd import block_clock
    from repro_torch.transport import get_transport
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    lo, hi = comm.lo, comm.lo + comm.n_local
    x = xs[lo:hi]
    out = {}
    for name in SPMD_REDUCTIONS:
        for wire in SPMD_WIRES:
            t = get_transport(wire, device=comm.device)
            before = (fused_accumulate.launches, fused_shift_accumulate.launches)
            y = _spmd_reduce(name, x, comm, t)
            if y.is_cuda:
                torch.cuda.synchronize()
            r = {"equal": same_bits(y, wants[name][lo:hi]),
                 "finite": bool(torch.isfinite(y).all()),
                 "stats": (t.stats.steps, t.stats.bytes_moved),
                 "launches": (fused_accumulate.launches - before[0],
                              fused_shift_accumulate.launches - before[1])}
            del y
            if reps:
                def fn(t=t, name=name):
                    _spmd_reduce(name, x, comm, t)

                fn()
                t0 = block_clock(comm)
                for _ in range(reps):
                    fn()
                r["stamps"] = (t0, block_clock(comm))
            out[f"{name}/{wire}"] = r
    return out


def _spmd_reductions(grp, dev) -> dict:
    """Phase 59 (b): the reductions of 8 x 16 Mi float32 on the rank
    processes against the stacked ``smi:static`` run, bit for bit with equal
    counters, A launched in the processes on ``smi:fused``; ms of each
    beside the stacked run's, in turns (stacked, process, process,
    stacked)."""
    import torch

    from repro_torch.core import Communicator
    from repro_torch.transport import get_transport

    g = torch.Generator(device=dev).manual_seed(59)
    xs = torch.randn((P, REDUCE_ELEMS), generator=g, device=dev)
    res, launches = {}, 0
    for layout, (names, sizes) in SPMD_LAYOUTS.items():
        comm = Communicator.create(names, sizes, device=dev)
        comm_args = {"axis_names": names, "axis_sizes": sizes}
        wants, stats = {}, {}
        for name in SPMD_REDUCTIONS:
            t = get_transport("static", device=dev)
            wants[name] = _spmd_reduce(name, xs, comm, t)
            stats[name] = (t.stats.steps, t.stats.bytes_moved)
        torch.cuda.synchronize()
        checked = grp.run(_spmd_reduce_rank, comm_args, xs=xs, wants=wants, reps=0)
        for key, r in checked.items():
            name, wire = key.split("/")
            what = f"ranks as processes: {name} on {layout} over smi:{wire}"
            if r["equal"] != [True] * SPMD_PROCS or r["finite"] != [True] * SPMD_PROCS:
                raise AssertionError(f"{what}: not bit-equal to the stacked smi:static "
                                     f"({r['equal']}, finite {r['finite']})")
            if r["stats"] != [stats[name]] * SPMD_PROCS:
                raise AssertionError(f"{what}: counters {r['stats']} != the stacked "
                                     f"{stats[name]}")
            folds = [f for f, _ in r["launches"]]
            if any(s for _, s in r["launches"]):
                raise AssertionError(f"{what}: the gather-fused form ran in a rank process "
                                     f"({r['launches']}); its gather cannot see a peer's rows")
            if wire == "fused" and min(folds) == 0 and xs.is_cuda:
                raise AssertionError(f"{what}: a rank process never launched kernel A "
                                     f"({r['launches']})")
            if wire == "static" and max(folds) > 0:
                raise AssertionError(f"{what}: kernel A launched on the static wire")
            if wire == "fused" and name == "allreduce":
                launches += sum(folds)
        log(f"ranks as processes: {', '.join(SPMD_REDUCTIONS)} on {layout} over smi:static "
            f"and smi:fused bit-equal to the stacked smi:static in every process, counters "
            f"equal ({stats}); kernel A {[f for f, _ in checked['allreduce/fused']['launches']]} "
            f"launches a process on the fused all-reduce")
        del checked
        turns = {k: {"stacked": [], "process": []} for k in
                 (f"{n}/{w}" for n in SPMD_REDUCTIONS for w in SPMD_WIRES)}
        for mode in ("stacked", "process", "process", "stacked"):
            if mode == "stacked":
                for key in turns:
                    name, wire = key.split("/")
                    t = get_transport(wire, device=dev)
                    turns[key][mode].append(time_ms(lambda: _spmd_reduce(name, xs, comm, t),
                                                    reps=SPMD_REPS, warmup=1))
            else:
                timed = grp.run(_spmd_reduce_rank, comm_args, xs=xs, wants=wants,
                                reps=SPMD_REPS)
                for key, r in timed.items():
                    stamps = r["stamps"]
                    turns[key][mode].append((max(b for _, b in stamps)
                                             - min(a for a, _ in stamps)) * 1e3 / SPMD_REPS)
        for key, tk in turns.items():
            row = {m: sum(v) / len(v) for m, v in tk.items()} | {"turns_ms": tk}
            res[f"{key.split('/')[0]}/{layout}/smi:{key.split('/')[1]}"] = row
            log(f"ranks as processes: {key} on {layout}: {row['process']:.4f} ms a call "
                f"against {row['stacked']:.4f} stacked ({row['process'] / row['stacked']:.2f}x; "
                f"turns {tk['stacked'][0]:.4f}, {tk['process'][0]:.4f}, "
                f"{tk['process'][1]:.4f}, {tk['stacked'][1]:.4f})")
        del wants
    del xs
    torch.cuda.empty_cache()
    return {"ms": res, "launches_a_allreduce": launches}


def _spmd_stencil(grp, dev) -> dict:
    """Phase 59 (a): the 2x4 stencil at 8192x8192, 8 steps, overlapped and
    not, through the launcher's process-mode run (``launch.stencil
    run_process``: a first run, then a timed run between barrier-aligned
    stamps) on ``grp``'s processes and stacked, in turns (stacked, process,
    process, stacked) on one world made on the card: every run's tiles
    bit-equal to the first stacked run's and to the single-rank sweep, its
    timed run's to its first, B launched in every process on the overlapped
    schedule, the ``halo`` steps and bytes the stacked run's; wall a step."""
    import torch

    from repro_torch.apps import HALO_TAG, DistributedStencil
    from repro_torch.launch.stencil import run_process

    app = DistributedStencil.create(DIMS, comm_mode="smi:static", device=dev)
    g = torch.Generator(device=dev).manual_seed(59)
    world = torch.randn(SPMD_DOMAIN, generator=g, device=dev)
    tiles = app.scatter(world)
    single = app.single_rank_reference(world, SPMD_STEPS)

    def stacked(overlapped: bool) -> dict:
        tp = app.halo_schedule.resolve_transport(tiles)
        got = app.run(tiles, SPMD_STEPS, overlapped=overlapped, transport=tp)
        halo = tp.stats.tag_counts(HALO_TAG)
        tp.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = app.run(tiles, SPMD_STEPS, overlapped=overlapped, transport=tp)
        torch.cuda.synchronize()
        return {"got": got, "timed": timed, "halo": halo, "wall": time.perf_counter() - t0,
                "halo_timed": tp.stats.tag_counts(HALO_TAG)}

    out = {}
    for sched in ("overlapped", "reference"):
        overlapped = sched == "overlapped"
        runs, first = {"stacked": [], "process": []}, None
        for mode in ("stacked", "process", "process", "stacked"):
            r = stacked(overlapped) if mode == "stacked" else run_process(
                grp, app, tiles, SPMD_STEPS, overlapped, "smi:static", None)
            first = r if first is None else first
            what = f"stencil {sched} ({mode}, {grp.n_procs} processes)"
            if not (same_bits(app.gather(r["got"]), single) and same_bits(r["got"], first["got"])
                    and same_bits(r["timed"], r["got"])):
                raise AssertionError(f"{what}: tiles differ from the single-rank sweep or the "
                                     f"stacked run")
            if r["halo"] != first["halo"] or r["halo_timed"] != first["halo"]:
                raise AssertionError(f"{what}: halo {r['halo']}, {r['halo_timed']} against "
                                     f"the stacked {first['halo']}")
            if mode == "process" and overlapped and tiles.is_cuda and min(r["launches_b"]) == 0:
                raise AssertionError(f"{what}: a rank process never launched kernel B "
                                     f"({r['launches_b']})")
            runs[mode].append({"ms": r["wall"] * 1e3 / SPMD_STEPS,
                               "launches_b": r.get("launches_b"), "peaks": r.get("peaks")})
            del r
        ms = {m: [v["ms"] for v in rs] for m, rs in runs.items()}
        b = [v["launches_b"] for v in runs["process"]]
        out[sched] = {"ms_per_step": {m: sum(v) / len(v) for m, v in ms.items()},
                      "turns_ms": ms, "halo": list(first["halo"]), "launches_b": b,
                      "peak_bytes": runs["process"][-1]["peaks"]}
        log(f"ranks as processes: stencil {sched} at {grp.n_procs} processes, {SPMD_STEPS} "
            f"steps: ms a step {out[sched]['ms_per_step']['process']:.4f} against "
            f"{out[sched]['ms_per_step']['stacked']:.4f} stacked (turns {ms}); every run "
            f"bit-equal to the stacked run and the single-rank sweep; halo {first['halo']} a "
            f"rank as stacked; kernel B launches a process {b[0]}; peak bytes a process "
            f"{runs['process'][-1]['peaks']}")
        del first
    return out


def _spmd_stencil_launcher(grp) -> dict:
    """Phase 59 (a) at ``grp``'s layout through the launcher itself
    (``launch.stencil --ranks process``, overlapped): bit-equal to the
    single-rank sweep, B launched in every process; wall a step."""
    from repro_torch.launch import stencil as launch_stencil

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "process.json")
        rc = launch_stencil.main([*SPMD_STENCIL_ARGS, "--ranks", "process", "--procs",
                                  str(grp.n_procs), "--json", path], group=grp)
        r = json.loads(Path(path).read_text())
    on_card = grp.devices[0].type == "cuda"  # a CPU rehearsal runs plain versions
    if rc != 0 or not r["ok"] or r["max_err"] != 0.0 or (on_card and min(r["launches_b"]) == 0):
        raise AssertionError(f"stencil overlapped at {grp.n_procs} processes: rc={rc} {r}")
    log(f"ranks as processes: launch.stencil --ranks process --procs {grp.n_procs}: "
        f"{r['wall_per_step_s'] * 1e3:.4f} ms a step, bit-equal to the single-rank sweep, halo "
        f"({r['halo_steps']}, {r['halo_bytes_per_rank']}), kernel B launches a process "
        f"{r['launches_b']}")
    return {"ms_per_step": r["wall_per_step_s"] * 1e3, "launches_b": r["launches_b"],
            "halo": [r["halo_steps"], r["halo_bytes_per_rank"]], "peak_bytes": r["peak_bytes"]}


def _spmd_latency(grp, dev) -> dict:
    """Phase 59 (c): ``launch.channels.latency`` over static, fused and
    packet at 1, 4 and 7 hops (Tab. 3's shape), the checks of phase 21
    (delivery bit for bit, the first element on the hops-th pop, every one
    of :data:`SPMD_POPS` delivered), stacked and with the ranks as
    ``grp``'s processes in turns; µs a transfer and a pop, and C's
    block-tick launches of each process's runs."""
    from repro_torch.launch.channels import LAT_WIRES, _line, latency

    rows = {"stacked": [], "process": []}
    launches = [0] * grp.n_procs
    for mode in ("stacked", "process", "process", "stacked"):
        if mode == "stacked":
            rows[mode].append(latency(dev, LAT_WIRES, count=SPMD_POPS, reps=10))
            continue
        got, n = _launched(grp, lambda: latency(dev, LAT_WIRES, count=SPMD_POPS, reps=10,
                                                 group=grp))
        rows[mode].append(got)
        launches = [a + b for a, b in zip(launches, n["C"])]
    if dev.type == "cuda" and min(launches) == 0:
        raise AssertionError(f"packet latency: a rank process never launched C's block-tick "
                             f"form ({launches})")
    out = {"launches_c": launches}
    for i, row in enumerate(rows["process"][0]):
        key = f"hops={row['hops']}/{row['wire']}"
        out[key] = {m: {k: sum(r[i][k] for r in rs) / len(rs)
                        for k in ("us_per_transfer", "us_per_pop")} for m, rs in rows.items()}
        log(_line(row) + f"; stacked in turns {out[key]['stacked']['us_per_transfer']:.2f} "
            f"us/transfer, {out[key]['stacked']['us_per_pop']:.2f} us/pop; process mean "
            f"{out[key]['process']['us_per_transfer']:.2f}, "
            f"{out[key]['process']['us_per_pop']:.2f}")
    return out


# -- the packet wire with the ranks as processes (slice 16) -------------------------------

#: phase 59 (d): the packet stencil's halo over SPMD_STEPS steps (PACKET_HALO is 32 steps')
SPMD_PACKET_HALO = (PACKET_HALO[0] // 32 * SPMD_STEPS, PACKET_HALO[1] // 32 * SPMD_STEPS)
#: phase 59 (e): the packet reductions' message, 64 Ki float32 a rank at 2048 a
#: packet (phase 11's packet size): a ring step's block is a train of 4
#: packets, so arbitration and ordering are exercised, while a process-mode
#: tick (a launch, a stream synchronise and a host barrier in every process)
#: keeps the 16 Mi of phase 11 (1,029 ticks a ring step) out of the time limit
SPMD_PACKET_ELEMS = 64 * 1024
SPMD_PACKET_PKT = 2048
SPMD_PACKET_LAYOUTS = {"ring(1x8)": (("x",), (8,), False),
                       "torus(2x4)": (("x", "y"), DIMS, False),
                       "snake_bus(2x4)": (("x", "y"), DIMS, True)}


def _spmd_counts(comm) -> dict:
    """A rank process's launch counters of kernel C's block-tick form and of
    kernel B (read before and after a sub-phase: the difference is its
    launches in that process) and its crossing steps so far."""
    from repro_torch.kernels.router import router_tick_block
    from repro_torch.kernels.stencil import stencil_sweep

    return {"C": router_tick_block.launches, "B": stencil_sweep.launches,
            "steps": comm.group.steps}


def _launched(grp, call):
    """``call()`` (work on ``grp``'s processes) and each process's launches
    of C's block-tick form and of B, and its crossing steps, in it."""
    comm_args = {"axis_names": ("x",), "axis_sizes": (grp.n_ranks,)}
    before = grp.run(_spmd_counts, comm_args)
    out = call()
    after = grp.run(_spmd_counts, comm_args)
    return out, {k: [a - b for a, b in zip(after[k], before[k])] for k in before}


def _spmd_packet_stencil_rank(comm, *, tiles, want, overlapped: bool, steps: int) -> dict:
    """Phase 59 (d) in a rank process: one run of ``steps`` steps of the 2x4
    stencil over ``smi:packet`` on its rows of ``tiles`` (the parent's
    stack, mapped from the parent's memory) between barrier-aligned stamps;
    whether its tiles are bit-equal to its rows of ``want`` (mapped too), the
    ``halo`` counters and the overflow of the ranks held here."""
    from repro_torch.apps import HALO_TAG, DistributedStencil
    from repro_torch.core.spmd import block_clock

    lo, hi = comm.lo, comm.lo + comm.n_local
    app = DistributedStencil.create(DIMS, comm=comm, comm_mode="smi:packet")
    tp = app.halo_schedule.resolve_transport(tiles[lo:hi])
    t0 = block_clock(comm)
    got = app.run(tiles[lo:hi], steps, overlapped=overlapped, transport=tp)
    t1 = block_clock(comm)
    return {"equal": same_bits(got, want[lo:hi]), "halo": tp.stats.tag_counts(HALO_TAG),
            "overflow": int(tp.stats.overflow.sum()), "t0": t0, "t1": t1}


def _spmd_packet_stencil(groups, dev) -> dict:
    """Phase 59 (d): the 2x4 stencil at 8192x8192 over ``smi:packet``,
    :data:`SPMD_STEPS` steps, overlapped and not, stacked and on each group
    of rank processes (8 of one rank, 2 of four: in-process links beside
    crossing ones): every tile bit-equal to the stacked packet run's and to
    the single-rank sweep, the ``halo`` counters the stacked run's
    (:data:`SPMD_PACKET_HALO`), no overflow, C's block-tick form launched in
    every process and B in every process on the overlapped schedule; ms a
    step and a tick beside the stacked run's."""
    import torch

    from repro_torch.apps import HALO_TAG, DistributedStencil

    app = DistributedStencil.create(DIMS, comm_mode="smi:packet", device=dev)
    g = torch.Generator(device=dev).manual_seed(59)
    world = torch.randn(SPMD_DOMAIN, generator=g, device=dev)
    tiles = app.scatter(world)
    single = app.single_rank_reference(world, SPMD_STEPS)
    comm_args = {"axis_names": app.comm.axis_names, "axis_sizes": app.comm.axis_sizes}
    out = {}
    for sched in ("overlapped", "reference"):
        overlapped = sched == "overlapped"
        tp = app.halo_schedule.resolve_transport(tiles)
        want, stacked_ms = _timed_ms(lambda: app.run(tiles, SPMD_STEPS, overlapped=overlapped,
                                                     transport=tp))
        halo = tp.stats.tag_counts(HALO_TAG)
        if not same_bits(app.gather(want), single) or halo != SPMD_PACKET_HALO \
                or int(tp.stats.overflow.sum()) != 0:
            raise AssertionError(f"packet stencil {sched} (stacked): tiles or halo {halo} "
                                 f"wrong, or packets lost")
        row = {"stacked_ms_per_step": stacked_ms / SPMD_STEPS, "halo": list(halo)}
        for grp in groups:
            what = f"packet stencil {sched} at {grp.n_procs} processes"
            r, n = _launched(grp, lambda: grp.run(
                _spmd_packet_stencil_rank, comm_args, tiles=tiles, want=want,
                overlapped=overlapped, steps=SPMD_STEPS))
            if r["equal"] != [True] * grp.n_procs:
                raise AssertionError(f"{what}: tiles differ from the stacked packet run and the "
                                     f"single-rank sweep ({r['equal']})")
            if r["halo"] != [halo] * grp.n_procs or any(r["overflow"]):
                raise AssertionError(f"{what}: halo {r['halo']} against the stacked {halo}, "
                                     f"overflow {r['overflow']}")
            if tiles.is_cuda and (min(n["C"]) == 0 or (overlapped and min(n["B"]) == 0)):
                raise AssertionError(f"{what}: a rank process launched C's block-tick form "
                                     f"{n['C']} and B {n['B']} times")
            ms = (max(r["t1"]) - min(r["t0"])) * 1e3
            ticks = n["steps"][0]
            row[f"procs{grp.n_procs}"] = {
                "ms_per_step": ms / SPMD_STEPS, "ticks": ticks, "ms_per_tick": ms / ticks,
                "launches_c": n["C"], "launches_b": n["B"]}
            log(f"ranks as processes: {what}, {SPMD_STEPS} steps: {ms / SPMD_STEPS:.4f} ms a "
                f"step against {stacked_ms / SPMD_STEPS:.4f} stacked, {ticks} ticks "
                f"({ms / ticks:.4f} ms a tick, a launch, a stream synchronise and a barrier); "
                f"bit-equal to the stacked packet run and the single-rank sweep, halo {halo}, "
                f"overflow 0; C's block-tick form {n['C']} and B {n['B']} launches a process")
            del r
        out[sched] = row
    return out


def _spmd_packet_reduce_rank(comm, *, xs, wants, snake: bool, pkt_elems: int) -> dict:
    """Phase 59 (e) in a rank process: its rows of ``xs`` through each
    reduction of :data:`SPMD_REDUCTIONS` over ``smi:packet`` (on the snake
    bus embedded in the torus with ``snake``), against its rows of the
    stacked ``smi:static`` result; the counters, the overflow of the ranks
    held here and the stamps around each call."""
    import torch

    from repro_torch.core import snake_bus
    from repro_torch.core.spmd import block_clock
    from repro_torch.transport import get_transport

    if snake:
        comm = comm.with_topology(snake_bus(tuple(comm.axis_sizes)))
    lo, hi = comm.lo, comm.lo + comm.n_local
    out = {}
    for name in SPMD_REDUCTIONS:
        t = get_transport("packet", device=comm.device, pkt_elems=pkt_elems)
        t0 = block_clock(comm)
        y = _spmd_reduce(name, xs[lo:hi], comm, t)
        t1 = block_clock(comm)
        out[name] = {"equal": same_bits(y, wants[name][lo:hi]),
                     "finite": bool(torch.isfinite(y).all()),
                     "stats": (t.stats.steps, t.stats.bytes_moved),
                     "overflow": int(t.stats.overflow.sum()), "stamps": (t0, t1)}
    return out


def _spmd_packet_reductions(grp, dev) -> dict:
    """Phase 59 (e): ``allreduce`` and ``reduce_scatter`` of
    :data:`SPMD_PACKET_ELEMS` float32 a rank over ``smi:packet`` (±1 ring
    shifts only) on ring(1x8), torus(2x4) and snake_bus(2x4), ranks as
    ``grp``'s processes: each process's rows bit-equal to the stacked
    ``smi:static`` run's, the counters the stacked packet run's, overflow 0,
    C's block-tick form launched in every process; ms a call beside the
    stacked packet run's."""
    import torch

    from repro_torch.core import Communicator, snake_bus
    from repro_torch.transport import get_transport

    g = torch.Generator(device=dev).manual_seed(60)
    xs = torch.randn((P, SPMD_PACKET_ELEMS), generator=g, device=dev)
    out, launches = {}, 0
    for layout, (names, sizes, snake) in SPMD_PACKET_LAYOUTS.items():
        comm = Communicator.create(names, sizes, topology=snake_bus(sizes) if snake else None,
                                   device=dev)
        wants, stacked = {}, {}
        for name in SPMD_REDUCTIONS:
            wants[name] = _spmd_reduce(name, xs, comm, get_transport("static", device=dev))
            tp = get_transport("packet", device=dev, pkt_elems=SPMD_PACKET_PKT)
            y, ms = _timed_ms(lambda: _spmd_reduce(name, xs, comm, tp))
            if not same_bits(y, wants[name]) or int(tp.stats.overflow.sum()) != 0:
                raise AssertionError(f"{name} on {layout}: stacked smi:packet != smi:static")
            stacked[name] = {"ms": ms, "stats": (tp.stats.steps, tp.stats.bytes_moved)}
        r, n = _launched(grp, lambda: grp.run(_spmd_packet_reduce_rank,
                                              {"axis_names": names, "axis_sizes": sizes},
                                              xs=xs, wants=wants, snake=snake,
                                              pkt_elems=SPMD_PACKET_PKT))
        if xs.is_cuda and min(n["C"]) == 0:
            raise AssertionError(f"packet reductions on {layout}: a rank process never "
                                 f"launched C's block-tick form ({n['C']})")
        launches += sum(n["C"])
        for name in SPMD_REDUCTIONS:
            got, what = r[name], f"ranks as processes: {name} on {layout} over smi:packet"
            if got["equal"] != [True] * grp.n_procs or got["finite"] != [True] * grp.n_procs \
                    or any(got["overflow"]):
                raise AssertionError(f"{what}: not bit-equal to the stacked smi:static "
                                     f"({got['equal']}) or packets lost ({got['overflow']})")
            if got["stats"] != [stacked[name]["stats"]] * grp.n_procs:
                raise AssertionError(f"{what}: counters {got['stats']} != the stacked "
                                     f"{stacked[name]['stats']}")
            ms = (max(b for _, b in got["stamps"]) - min(a for a, _ in got["stamps"])) * 1e3
            out[f"{name}/{layout}"] = {"process_ms": ms, "stacked_ms": stacked[name]["ms"],
                                       "ticks_budgeted": stacked[name]["stats"][0]}
            log(f"{what}: bit-equal to the stacked smi:static in every process, overflow 0, "
                f"counters the stacked packet run's ({stacked[name]['stats']}); {ms:.4f} ms "
                f"a call against {stacked[name]['ms']:.4f} stacked")
        log(f"ranks as processes: packet reductions on {layout}: C's block-tick form "
            f"{n['C']} launches a process, {n['steps'][0]} ticks crossed")
    del xs
    return {"ms": out, "launches_c": launches}


def _spmd_reroute_rank(comm, pay, dst, ln, *, tbls: dict, x) -> dict:
    """Phase 59 (g) in a rank process: one ``RouterConfig`` routed on the
    torus table, then on the snake-bus table, and one packet transport
    instance shifting ``x`` over the torus, then the snake bus; whether the
    kernel library stayed the one loaded (no rebuild, no reload)."""
    from repro_torch.core import RouterConfig, run_router, snake_bus
    from repro_torch.kernels import build
    from repro_torch.transport import get_transport

    def loaded():  # a CPU rehearsal loads no library
        if comm.device.type != "cuda":
            return None
        return build.library(), build._digest(), build.library.cache_info().misses

    before = loaded()
    out = {name: run_router(RouterConfig(dims=DIMS), comm, tbl, pay, dst, ln, 64)
           for name, tbl in tbls.items()}
    t = get_transport("packet", device=comm.device)
    lo, hi = comm.lo, comm.lo + comm.n_local
    for name, c in (("torus", comm), ("snake_bus", comm.with_topology(snake_bus(DIMS)))):
        out[f"shift/{name}"] = t.shift(x[lo:hi], c, -1)
    out["tables"] = len(t._tbl_cache)
    out["overflow"] = int(t.stats.overflow.sum())
    after = loaded()
    out["same_library"] = before is None or (after[0] is before[0] and after[1:] == before[1:])
    return out


def _spmd_reroute(grp, dev) -> dict:
    """Phase 59 (g): phase 8's re-route with the ranks as ``grp``'s
    processes (torus table, then snake-bus table, one config; everything
    delivered, nothing lost), and one packet transport instance shifting
    over both; the kernel library neither rebuilt nor reloaded in any
    process."""
    import torch

    from repro_torch.core import Communicator, RouterConfig, snake_bus
    from repro_torch.transport import get_transport

    cfg = RouterConfig(dims=DIMS)
    msgs = [(0, 0, 5, 9.0), (2, 1, 6, 8.0), (7, 0, 1, 3.0), (4, 1, 3, 2.0), (6, 0, 0, 7.0)]
    staged = _stage(dev, cfg.n_ports, cfg.fifo_cap, cfg.pkt_elems, msgs)
    g = torch.Generator(device=dev).manual_seed(61)
    x = torch.randn((P, 1000), generator=g, device=dev)
    comm_args = {"axis_names": ("x", "y"), "axis_sizes": DIMS}
    r, n = _launched(grp, lambda: grp.run(_spmd_reroute_rank, comm_args, *staged,
                                          tbls=_tables(dev), x=x))
    comm = Communicator.create(("x", "y"), DIMS, device=dev)
    for topo in ("torus", "snake_bus"):
        out_pay, out_cnt, ovf, _ = r[topo]
        if int(ovf.sum()) != 0:
            raise AssertionError(f"re-route {topo} with ranks as processes: packets lost")
        for _s, p, d, val in msgs:
            if val not in out_pay[d, p, :int(out_cnt[d, p]), 0].tolist():
                raise AssertionError(f"re-route {topo} with ranks as processes: message {val} "
                                     f"not delivered")
        c = comm if topo == "torus" else comm.with_topology(snake_bus(DIMS))
        want = get_transport("static", device=dev).shift(x, c, -1)
        if not same_bits(r[f"shift/{topo}"].to(dev), want):
            raise AssertionError(f"packet shift over {topo} with ranks as processes != static")
    if r["tables"] != [2] * grp.n_procs or any(r["overflow"]) \
            or r["same_library"] != [True] * grp.n_procs:
        raise AssertionError(f"re-route with ranks as processes: tables {r['tables']}, overflow "
                             f"{r['overflow']}, library kept {r['same_library']}")
    if dev.type == "cuda" and min(n["C"]) == 0:
        raise AssertionError(f"re-route: a rank process never launched C's block-tick form")
    log(f"re-route with ranks as {grp.n_procs} processes: torus then snake bus on one config "
        f"and on one packet transport ({r['tables'][0]} tables cached a process), "
        f"{len(msgs)} messages delivered, shifts equal to static, no loss; the kernel library "
        f"neither rebuilt nor reloaded in any process; C's block-tick form {n['C']} launches "
        f"a process")
    return {"launches_c": sum(n["C"])}


def _block_tick_chain(fn, spec, tbl, src, pay, dst, ln, n_steps: int, n_block: int,
                      tick_batch: int, check=None):
    """A whole router run stepped tick by tick with ``fn`` (kernel C's
    block-tick form or its plain version) on blocks of ``n_block`` ranks,
    each on its own state, the link exchange a gather of every block's send
    rows between ticks (what the rank processes' mailboxes move); the final
    arrivals absorbed.  ``check(t, states, snd, pending)`` sees every tick.
    Returns the blocks' states and the ticks run."""
    import torch

    from repro_torch.kernels.router import init_state
    from repro_torch.kernels.router.ref import ROW_HEAD

    dev = pay.device
    los = range(0, P, n_block)
    sts = [init_state(spec, n_block, dev) for _ in los]
    lanes = torch.arange(spec.n_links, device=dev)
    arr = torch.zeros((P, spec.n_links, ROW_HEAD + spec.pkt_elems), dtype=torch.int32,
                      device=dev)
    B = max(1, min(tick_batch, n_steps))
    while n_steps % B:
        B -= 1
    t = 0
    while t < n_steps:
        for _ in range(B):
            snds, pends = [], []
            for i, lo in enumerate(los):
                hi = lo + n_block
                sts[i], snd, pend = fn(spec, tbl[lo:hi], pay[lo:hi], dst[lo:hi], ln[lo:hi],
                                       sts[i], arr[lo:hi], lo, t)
                snds.append(snd)
                pends.append(pend)
            snd, pend = torch.cat(snds), torch.cat(pends)
            if check is not None:
                check(t, sts, snd, pend)
            arr = snd[src, lanes]
            t += 1
        if int(pend.sum()) == 0:
            break
    for i, lo in enumerate(los):
        sts[i], _, _ = fn(spec, tbl[lo:lo + n_block], pay[lo:lo + n_block],
                          dst[lo:lo + n_block], ln[lo:lo + n_block], sts[i],
                          arr[lo:lo + n_block], lo, t, arbitrate=False)
    if check is not None:
        check(t, sts, None, None)
    return sts, t


def _block_tick_case(dev, name, cfg, tbl, pay, dst, ln, n_steps) -> dict:
    """Phase 59 (f), one case: a whole run stepped tick by tick through the
    plain version on one block of all P ranks (``router_tick`` on the
    stacked state), then through C's block-tick form on blocks of 1 and of
    4 ranks, each block bit-equal to its rows of the plain run on every
    output of every tick (the whole state, the send rows, the pending
    counts), and the result bit-equal to the stacked run (``run_router``,
    ``impl="vector"``).  Returns, by block size, what phase 59 (f) times:
    the spec, the exchange table, the ticks and the inputs of the first
    block's middle tick."""
    import torch

    from repro_torch.core import Communicator, run_router
    from repro_torch.core.router import _fabric
    from repro_torch.kernels.router import (
        router_tick_block,
        router_tick_block_plain,
        tick_spec_of,
    )

    _, link_ids, src = _fabric(tuple(cfg.dims), dev)
    spec = tick_spec_of(cfg, P, link_ids)
    batch = 4 if cfg.tick_batch is None else cfg.tick_batch
    src = src.long()
    plain = {}

    def record(t, sts, snd, pend):
        plain[t] = ({k: v.clone() for k, v in sts[0].items()}, snd, pend)

    _, ticks = _block_tick_chain(router_tick_block_plain, spec, tbl, src, pay, dst, ln, n_steps,
                                 P, batch, record)
    comm = Communicator.create(tuple(f"a{i}" for i in range(len(cfg.dims))), cfg.dims,
                               device=dev)
    want = run_router(cfg, comm, tbl, pay, dst, ln, n_steps, impl="vector")
    out = {}
    for n_block in (1, 4):
        def compare(t, sts, snd, pend):
            want_st, want_snd, want_pend = plain[t]
            for i, st in enumerate(sts):
                for k, v in st.items():
                    if not same_bits(v, want_st[k][i * n_block:(i + 1) * n_block]):
                        raise AssertionError(f"block tick {name}, {n_block}-rank blocks: block "
                                             f"{i} differs from the plain version on {k} at "
                                             f"tick {t}")
            if snd is not None and not (same_bits(snd, want_snd) and same_bits(pend, want_pend)):
                raise AssertionError(f"block tick {name}, {n_block}-rank blocks: send rows or "
                                     f"pending differ from the plain version at tick {t}")

        before = router_tick_block.launches
        sts, kticks = _block_tick_chain(router_tick_block, spec, tbl, src, pay, dst, ln, n_steps,
                                        n_block, batch, compare)
        torch.cuda.synchronize()
        launches = router_tick_block.launches - before
        # a launch a block a tick, and one a block for the final absorb (the
        # plain version on a CPU rehearsal launches nothing)
        if kticks != ticks or (pay.is_cuda and launches != (ticks + 1) * (P // n_block)):
            raise AssertionError(f"block tick {name}: {kticks} ticks against the plain {ticks}, "
                                 f"{launches} launches")
        got = [torch.cat([st[k] for st in sts]) for k in ("out_pay", "out_cnt", "overflow",
                                                           "t_done")]
        if not all(same_bits(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"block tick {name}: the stepped run != the stacked run")
        log(f"block tick {name:>26}, {n_block}-rank blocks: every tick's state, send rows and "
            f"pending bit-equal to the plain version, the result to the stacked run ({ticks} "
            f"ticks, delivered {int(got[1].sum())}, overflow {int(got[2].sum())})")
        # the first block's state after the middle tick and its arrivals: the
        # inputs of one mid-run tick, on which the plain version is timed
        mid = ticks // 2
        st, snd, _ = plain[mid - 1]
        arr = snd[src, torch.arange(spec.n_links, device=dev)][:n_block]
        out[n_block] = {"spec": spec, "src": src, "ticks": ticks, "overflow": int(got[2].sum()),
                        "mid": (mid, {k: v[:n_block] for k, v in st.items()}, arr)}
    return out


def phase_block_tick(dev) -> dict:
    """Phase 59 (f): kernel C's block-tick form against its plain version at
    the halo shape (phase 7's E/W permute: 128 packets of 32 float32 a
    rank), at a switch-bubble configuration on the snake-bus table and at
    an undersized transit that overflows, each on 1-rank and 4-rank blocks
    (:func:`_block_tick_case`); then at the halo shape the kernel's device
    time a launch (``torch.profiler``, its own rows) beside an empty launch
    of its grid (the tick floor), the plain version's time a call (CUDA
    events on one mid-run tick) and the bytes bound of a tick.  Returns the
    kernel table's row (``launches`` filled in by phase 59's runs)."""
    import numpy as np
    import torch

    from repro_torch.core import RouterConfig
    from repro_torch.kernels.build import current_stream
    from repro_torch.kernels.router import router_tick_block, router_tick_block_plain
    from repro_torch.kernels.router.ref import ROW_HEAD

    tables = _tables(dev)
    cases = []
    _, (cfg, tbl, pay, dst, ln, n_steps) = _halo_job(dev)
    cases.append(("halo shape", cfg, tbl, pay, dst, ln, n_steps))
    cfg_b = RouterConfig(dims=DIMS, fifo_cap=6, transit_cap=8, out_cap=16, pkt_elems=4,
                         **EQ_CFGS["ports2_bubble_r16"])
    rng = np.random.RandomState(59)
    msgs = [(s, p, rng.randint(0, P), float(rng.randint(1, 99)))
            for s in range(P) for p in range(2) for _ in range(rng.randint(0, 5))]
    cases.append(("ports2_bubble_r16/snake_bus", cfg_b, tables["snake_bus"],
                  *_stage(dev, 2, 6, 4, msgs), 64))
    cfg_o = RouterConfig(dims=DIMS, n_ports=2, fifo_cap=6, transit_cap=1, out_cap=16,
                         pkt_elems=4, R=4)
    msgs = [(s, p, (s + 2 + 3 * p) % P, float(10 * s + p)) for s in range(P) for p in range(2)
            for _ in range(3)]
    cases.append(("transit_cap_1", cfg_o, tables["torus"], *_stage(dev, 2, 6, 4, msgs), 64))
    res = {}
    for name, cfg, tbl, pay, dst, ln, n_steps in cases:
        for n_block, r in _block_tick_case(dev, name, cfg, tbl, pay, dst, ln, n_steps).items():
            res[(name, n_block)] = r
        if name == "transit_cap_1" and res[(name, 1)]["overflow"] == 0:
            raise AssertionError("block tick: an undersized transit counted no overflow")

    # the halo shape's times: a launch of the form on a block over a whole
    # stepped run and an empty launch of its grid (the floor), each by its
    # own kernel rows of one profile; the plain version on one mid-run tick
    name, cfg, tbl, pay, dst, ln, n_steps = cases[0]
    row = {"ms": {}, "tick_floor_ms": {}, "plain_ms": {}, "bound_ms": {}}
    stream = current_stream(pay)
    floor_reps = 200
    for n_block in (1, 4):
        case = res[(name, n_block)]
        spec, src = case["spec"], case["src"]

        def profiled():
            _block_tick_chain(router_tick_block, spec, tbl, src, pay, dst, ln, n_steps, n_block,
                              4)
            for _ in range(floor_reps):
                smoke_launch(smoke_lib().smoke_empty_tick(n_block, stream), "empty tick")

        for _ in range(PROFILE_TRIES):  # a profile that recorded no kernel is taken again
            before = router_tick_block.launches
            _, rows, _ = _profile_device_ms(profiled)
            launches = max(1, router_tick_block.launches - before)
            row["ms"][n_block] = sum(ms for k, ms in rows if "router_tick_block" in k) / launches
            row["tick_floor_ms"][n_block] = sum(ms for k, ms in rows if "empty_tick" in k) \
                / floor_reps
            if row["ms"][n_block] > 0 and row["tick_floor_ms"][n_block] > 0:
                break
        else:
            raise RuntimeError("torch.profiler recorded no block-tick or empty launch in "
                               f"{PROFILE_TRIES} profiles")
        mid, st, arr = case["mid"]
        row["plain_ms"][n_block] = time_ms(lambda: router_tick_block_plain(
            spec, tbl[:n_block], pay[:n_block], dst[:n_block], ln[:n_block], st, arr, 0, mid))
        # bytes of a tick: the arrivals read and the send rows written, the
        # control state (heads, counts, latches, pending) read and written
        ctrl = n_block * (2 * cfg.n_ports + 2 * spec.n_links + 5)
        nbytes = 4 * (2 * n_block * spec.n_links * (ROW_HEAD + cfg.pkt_elems) + 2 * ctrl)
        row["bound_ms"][n_block] = bound(nbytes, 0)[0]
        log(f"block tick at the halo shape, {n_block}-rank blocks: {row['ms'][n_block]:.5f} ms "
            f"a launch (device time over {launches} launches), an empty launch of its grid "
            f"{row['tick_floor_ms'][n_block]:.5f} ms, plain {row['plain_ms'][n_block]:.4f} ms "
            f"a call, bytes bound {row['bound_ms'][n_block]:.7f} ms")
    return dict(
        name="router_tick_block", route="cuda", path="block",
        source="src/repro_torch/csrc/router.cu", replaces="src/repro/kernels/router/kernel.py:83",
        launches=0, max_abs_err=0.0, ms=row["ms"][1], plain_ms=row["plain_ms"][1],
        bound_ms=row["bound_ms"][1], bound_by="bytes", library_ms=None,
        tick_floor_ms=row["tick_floor_ms"][1], tick_floor_by="a launch",
        at_4_rank_blocks={k: v[4] for k, v in row.items()},
        shape=[1] + list(pay.shape[1:]), dtype="float32")


def phase_spmd(dev) -> dict:
    """Phase 59: the ranks as processes on the card.  One spawn of 8 rank
    processes (one a rank, each its own CUDA context on the card) serves
    (a) the stencil, (b) the reductions and (c) channel latency; a group of
    2 processes of 4 ranks, spawned beside it (the two spawns' imports
    overlap), then runs the stencil launcher.  The packet wire runs on the
    same two groups: (f) kernel C's block-tick form against its plain
    version first (in this process), then (d) the packet stencil on both
    groups, (e) the packet reductions and (g) the table swap on the 8.
    Prints each process's start-up (context, mailboxes) and peak device
    memory."""
    from concurrent.futures import ThreadPoolExecutor
    from contextlib import ExitStack

    import torch

    from repro_torch.core import SpmdGroup

    res = {}
    t0 = time.perf_counter()
    free0 = torch.cuda.mem_get_info(dev)[0]
    with ExitStack() as stack, ThreadPoolExecutor(1) as pool:
        pending = pool.submit(SpmdGroup, 2, P, device=dev, slot_bytes=SPMD_SLOT_BYTES)
        grp = stack.enter_context(SpmdGroup(SPMD_PROCS, P, device=dev,
                                            slot_bytes=SPMD_SLOT_BYTES))
        grp2 = stack.enter_context(pending.result())
        res["spawn_s"] = time.perf_counter() - t0
        # what the processes took of the card beyond their mailboxes: each
        # one's CUDA context (and its share of the kernels' modules)
        startup = grp.startup + grp2.startup
        taken = free0 - torch.cuda.mem_get_info(dev)[0]
        res["context_bytes"] = (taken - sum(s["device_bytes"] or 0 for s in startup)) \
            / len(startup)
        for i, s in enumerate(startup):
            log(f"ranks as processes: process {i % SPMD_PROCS} of "
                f"{SPMD_PROCS if i < SPMD_PROCS else 2} ready in {s['start_s']:.3f} s (its "
                f"CUDA context and 2 x {SPMD_SLOT_BYTES} B a rank of mailbox), "
                f"{s['device_bytes']} B on the card")
        log(f"ranks as processes: {SPMD_PROCS} + 2 processes spawned and mapped in "
            f"{res['spawn_s']:.1f} s; the card's free memory fell {taken} B: "
            f"{res['context_bytes']:.0f} B a process beyond its mailbox (its context)")
        # the block-tick form checked against its plain version before any
        # rank process runs it
        t = time.perf_counter()
        res["block_tick_row"] = phase_block_tick(dev)
        log(f"phase 59 (f): {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        res["stencil"] = _spmd_stencil(grp, dev)
        log(f"phase 59 (a): {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        res["reductions"] = _spmd_reductions(grp, dev)
        log(f"phase 59 (b): {time.perf_counter() - t:.1f}s")
        for i, p in enumerate(grp.peaks):
            log(f"ranks as processes: process {i} peak device memory {p} B in the timed "
                f"reductions")
        t = time.perf_counter()
        res["latency"] = _spmd_latency(grp, dev)
        log(f"phase 59 (c): {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        res["stencil_procs2"] = _spmd_stencil_launcher(grp2)
        log(f"phase 59 (a) at 2 processes: {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        res["packet_stencil"] = _spmd_packet_stencil((grp, grp2), dev)
        log(f"phase 59 (d): {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        res["packet_reductions"] = _spmd_packet_reductions(grp, dev)
        log(f"phase 59 (e): {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        res["reroute"] = _spmd_reroute(grp, dev)
        log(f"phase 59 (g): {time.perf_counter() - t:.1f}s")
        res["startup"] = startup
    return res

# ------------------------------------------------------------------ parity
#
# Phase 60 (slice 17): the port at parity with the reference's launch layer:
# the packet wire's data-axis cell, training over smi:compressed and bulk,
# the stencil over smi:compressed, and the five examples on the card.

#: the packet wire's data-axis cell (the FSDP gather's steps once over-counted)
PARITY_PACKET_ARGS = ["--arch", "yi-6b", "--smoke", "--mesh", "2,4", "--comm-mode", "smi:packet",
                      "--validate-comm"]
PARITY_MESH = (2, 4)
#: the wires held against smi:static on phase 44's cut at (2, 4)
PARITY_WIRES = ("smi:compressed", "bulk")
PARITY_LOSS_RTOL = 1e-2
PARITY_GRAD_COS = 0.99
PARITY_STENCIL_ARGS = STENCIL_ARGS[:-1] + ["smi:compressed"]
PARITY_TRAIN_LM_ARGS = ["--full-100m", "--steps", "40"]


def _parity_packet_cell() -> dict:
    """The fault's cell: ``launch.train --smoke --mesh 2,4 --comm-mode
    smi:packet --validate-comm`` exits 0 (``fsdp.gather``'s steps equal the
    prediction) with kernel C routing the wire."""
    import contextlib
    import io

    import torch

    from repro_torch.kernels.router import router_run
    from repro_torch.launch import train as launch_train

    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(PARITY_PACKET_ARGS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"parity packet cell: {line}")
    gather = next((line.split() for line in lines if line.strip().startswith("fsdp.gather")), None)
    if rc != 0 or gather is None or router_run.launches == 0:
        raise AssertionError(f"launch.train {' '.join(PARITY_PACKET_ARGS)}: rc {rc}, "
                             f"fsdp.gather {gather}, C launched {router_run.launches}")
    return dict(seconds=secs, fsdp_gather_steps=int(gather[3]), launches_c=router_run.launches,
                launches_c_warp=router_run.warp_launches)


def _parity_train(dev, seed: int) -> tuple[dict, dict]:
    """yi-6b at phase 44's cut on (2, 4): ``launch.train --validate-comm``
    over ``smi:compressed`` (every tag equal to the prediction), then one
    batch's loss and gradients over each of :data:`PARITY_WIRES` against
    ``smi:static`` on the same params (loss within :data:`PARITY_LOSS_RTOL`
    relative, every leaf's cosine at least :data:`PARITY_GRAD_COS`), A's, D's
    and E's launches a step, and ms a step and peak GB of each wire, steps
    in turns."""
    import contextlib
    import io

    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.matmul import matmul
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.steps import build_train
    from repro_torch.optim import adamw_init
    from repro_torch.transport.fused import fused_accumulate, fused_shift_accumulate

    mesh = ",".join(map(str, PARITY_MESH))
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(["--arch", TRAIN_ARCH, "--layers", str(TRAIN_LAYERS), "--seq-len",
                                str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--mesh", mesh,
                                "--comm-mode", "smi:compressed", "--validate-comm"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    validate_s = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"parity validate smi:compressed: {line}")
    if rc != 0:
        raise AssertionError(f"launch.train --mesh {mesh} --comm-mode smi:compressed "
                             f"--validate-comm exited {rc}")
    n_tags = sum(1 for line in lines if line.rstrip().endswith(" ok"))

    cfg = _train_cfg(TRAIN_ARCH, TRAIN_LAYERS)
    shape = ShapeConfig("train_4k_cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    wires = ("smi:static", *PARITY_WIRES)
    arts = {w: build_train(cfg, shape, _train_settings(w), mesh=PARITY_MESH, matmul_fn=matmul,
                           device=dev) for w in wires}
    params = arts["smi:static"]["init_params"](seed)
    batches = _train_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, 7, seed)
    loss, launches, checks = {}, {}, {}
    want = None
    for w in wires:
        reset_counts()
        lw, _, g = arts[w]["grads"](params, batches[0])
        torch.cuda.synchronize()
        launches[w] = dict(D=matmul.launches, E=flash_attention_kernel.launches,
                           A=dict(fold=fused_accumulate.launches,
                                  shift=fused_shift_accumulate.launches))
        loss[w] = float(lw)
        _finite_nonzero(g, f"parity {w}")
        if want is None:
            want = g
            continue
        cos = _leaf_cosines(g, want)
        rel = abs(loss[w] - loss["smi:static"]) / abs(loss["smi:static"])
        checks[w] = dict(loss_rel=rel, min_leaf_cos=min(cos))
        del g
        if rel > PARITY_LOSS_RTOL or min(cos) < PARITY_GRAD_COS:
            raise AssertionError(f"parity {w}: loss {loss[w]} against smi:static's "
                                 f"{loss['smi:static']} (rel {rel:.3e}), least leaf cosine "
                                 f"{min(cos):.6f}")
        if launches[w]["D"] == 0 or launches[w]["E"] == 0:
            raise AssertionError(f"parity {w}: launches {launches[w]}")
    del want
    gc.collect()
    torch.cuda.empty_cache()
    log(f"parity train (2, 4): losses {loss}; against smi:static {checks}; launches a step "
        f"{launches}")
    state = {"params": params, "opt": adamw_init(params)}
    order = ("smi:static", "smi:compressed", "bulk", "bulk", "smi:compressed", "smi:static")
    turns, peaks = {w: [] for w in wires}, {w: 0.0 for w in wires}
    for w, b in zip(order, batches[1:]):
        torch.cuda.reset_peak_memory_stats()
        (_, m), t = _timed_ms(lambda: arts[w]["step"](state, b))
        if not torch.isfinite(m["loss"]):
            raise AssertionError(f"parity {w}: a step's loss is {m['loss']}")
        turns[w].append(t)
        peaks[w] = max(peaks[w], torch.cuda.max_memory_allocated() / 1e9)
    ms = {w: sum(v) / len(v) for w, v in turns.items()}
    log(f"parity train (2, 4): ms a step {ms} (in turns {turns}); peak GB {peaks}")
    del state, params, arts
    gc.collect()
    torch.cuda.empty_cache()
    return dict(validate_s=validate_s, validate_tags=n_tags, losses=loss, checks=checks,
                launches=launches, ms_per_step=ms, turns=turns, peak_gb=peaks), \
        launches["smi:compressed"]


def _parity_stencil() -> dict:
    """``launch.stencil`` at phase 4's cell over ``smi:compressed``: the
    launcher's lossy gate (max error under 1e-1 of the single-rank sweep),
    kernel B launched."""
    import torch

    from repro_torch.kernels.stencil import stencil_sweep
    from repro_torch.launch import stencil as launch_stencil

    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "stencil.json")
        rc = launch_stencil.main([*PARITY_STENCIL_ARGS, "--json", out])
        torch.cuda.synchronize()
        res = json.loads(Path(out).read_text())
    if rc != 0 or not res["ok"] or not 0.0 < res["max_err"] < launch_stencil.LOSSY_MAX_ERR \
            or stencil_sweep.launches == 0:
        raise AssertionError(f"stencil over smi:compressed: rc={rc} result={res}, B launched "
                             f"{stencil_sweep.launches}")
    log(f"parity stencil over smi:compressed: max|err| {res['max_err']:.4g}, "
        f"{res['wall_per_step_s'] * 1e3:.4f} ms a step, halo {res['halo_steps']} steps / "
        f"{res['halo_bytes_per_rank']} B a rank, B launched {stencil_sweep.launches}")
    return dict(max_err=res["max_err"], wall_per_step_ms=res["wall_per_step_s"] * 1e3,
                halo=(res["halo_steps"], res["halo_bytes_per_rank"]),
                launches_b=stencil_sweep.launches)


def _parity_examples() -> dict:
    """The five examples on the card at their reference defaults (the
    training example at ``--full-100m`` for 40 steps), each in this
    process: every assert of each holds, the quickstart's Chrome trace
    written to a temporary directory and read back, the training example's
    checkpoints at steps 20 and 40 and every CE it logs finite."""
    import contextlib
    import importlib
    import io
    import math

    import torch

    sys.path.insert(0, str(ROOT / "examples"))
    res = {}

    def run(name, fn):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            got = fn(importlib.import_module(name))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        res[name] = {"seconds": time.perf_counter() - t0}
        for line in out.getvalue().splitlines():
            log(f"{name}: {line}")
        return got

    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "quickstart_trace.json")
        qs = run("torch_quickstart", lambda m: m.main(["--trace", trace]))
        records = len(json.loads(Path(trace).read_text())["traceEvents"])
    if records != qs["records"] or qs["events"] == 0:
        raise AssertionError(f"torch_quickstart: {records} trace records read back, {qs}")
    res["torch_quickstart"].update(plan=str(qs["plan"]), trace_records=records)
    run("torch_stencil", lambda m: m.main())
    rows = run("torch_gesummv", lambda m: m.main([]))
    res["torch_gesummv"]["ms"] = {n: {"single": t1 * 1e3, "two_ranks": t2 * 1e3}
                                  for n, t1, t2 in rows}
    if run("torch_serve_lm", lambda m: m.main([])) != 0:
        raise AssertionError("torch_serve_lm exited non-zero")
    with tempfile.TemporaryDirectory() as tmp:
        hist = run("torch_train_lm", lambda m: m.main([*PARITY_TRAIN_LM_ARGS, "--ckpt-dir", tmp]))
        saved = sorted(os.listdir(tmp))
    ce = [h["ce"] for h in hist]
    # checkpoints every max(steps // 2, 10) steps and at the end (the newest
    # three kept), as the reference's example; its CE is not gated: the
    # tokens are uniform (the best CE is ln V) and the reference's own run of
    # this recipe ends above its start too
    steps = int(PARITY_TRAIN_LM_ARGS[PARITY_TRAIN_LM_ARGS.index("--steps") + 1])
    every = max(steps // 2, 10)
    want = [f"step_{s:08d}" for s in [*range(every, steps, every), steps][-3:]]
    if saved != want or hist[-1]["step"] != steps - 1 or not all(map(math.isfinite, ce)):
        raise AssertionError(f"torch_train_lm --full-100m: checkpoints {saved}, CE {ce}")
    res["torch_train_lm"].update(ce=ce, checkpoints=saved)
    return res


def phase_parity(dev, seed: int = 60) -> tuple[dict, dict]:
    """Phase 60: the packet wire's data-axis cell, yi-6b at phase 44's cut
    trained at (2, 4) over ``smi:compressed`` and ``bulk`` beside
    ``smi:static``, the stencil over ``smi:compressed`` and the five
    examples; returns the results and the ``smi:compressed`` step's
    launches."""
    res = {}
    for name, fn in (("packet_cell", _parity_packet_cell),
                     ("train", lambda: _parity_train(dev, seed)),
                     ("stencil", _parity_stencil), ("examples", _parity_examples)):
        t0 = time.perf_counter()
        res[name] = fn()
        log(f"phase 60 {name}: {time.perf_counter() - t0:.1f}s")
    res["train"], launches = res["train"]
    return res, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    phase_build()
    torch.cuda.synchronize()
    err_a = phase_accumulate(dev)
    torch.cuda.synchronize()
    err_b = phase_stencil_kernel(dev)
    torch.cuda.synchronize()
    launches_b, stencil = phase_stencil_path()
    for sched, res in stencil.items():
        log(f"stencil {sched}: {res['wall_per_step_s'] * 1e3:.4f} ms/step over "
            f"{res['steps']} steps, halo {res['halo_steps']} steps / "
            f"{res['halo_bytes_per_rank']} B per rank, equal to the single-rank sweep")
    phase_stencil_profile(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches_a, reduce_times = phase_reductions(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rows = phase_kernel_table(dev, launches_a, launches_b, err_a, err_b)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phases 1-6: {time.perf_counter() - t_start:.1f}s")

    t0 = time.perf_counter()
    _err_c, rows_c = phase_router_kernel(dev)
    torch.cuda.synchronize()
    log(f"phase 7 (kernel C vs plain): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_router_reroute(dev)
    torch.cuda.synchronize()
    log(f"phase 8 (re-route): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    injection = phase_injection(dev)
    torch.cuda.synchronize()
    log(f"phase 9 (injection): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches_c, packet_stencil = phase_packet_stencil()
    torch.cuda.synchronize()
    log(f"phase 10 (packet stencil): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    packet_profile = phase_stencil_profile(dev, n_steps=4, comm_mode="smi:packet",
                                           schedules=(True,))
    torch.cuda.synchronize()
    log(f"phase 10 (packet stencil profile): {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches_c_red = phase_packet_reductions(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 11 (packet reductions): {time.perf_counter() - t0:.1f}s")
    rows_c[0]["launches"] = launches_c
    rows_c[0]["launches_reductions"] = launches_c_red["warp"]
    rows_c[1]["launches"] = launches_c_red["thread"]
    rows.extend(rows_c)

    t0 = time.perf_counter()
    _err_e, row_e = phase_flash_kernel(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 12 (kernel E vs plain): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches_e, prefill = phase_prefill(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 13 (yi-6b prefill): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    serving = phase_serving()
    log(f"phase 14 (yi-6b serving): {time.perf_counter() - t0:.1f}s")
    row_e["launches"] = launches_e
    rows.append(row_e)

    t0 = time.perf_counter()
    _err_f, rows_f = phase_ssd_kernel(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 15 (kernel F vs plain): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches_f, ssm_prefill = phase_prefill(dev, "mamba2-2.7b", "F", seed=16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 16 (mamba2-2.7b prefill): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ssm_serving = phase_serving("mamba2-2.7b")
    log(f"phase 17 (mamba2-2.7b serving): {time.perf_counter() - t0:.1f}s")
    rows_f["wgmma"]["launches"] = launches_f
    rows_f["fma"]["launches"] = ssm_prefill["f32_fma_launches"]
    rows.extend((rows_f["wgmma"], rows_f["fma"]))

    t0 = time.perf_counter()
    _err_d, row_d = phase_matmul_kernel(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 18 (kernel D vs plain): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches_d, tp_prefill, tp_params = phase_tp_prefill(dev)
    torch.cuda.synchronize()
    log(f"phase 19 (yi-6b TP prefill, P = {TP}): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    tp_fused = phase_tp_fused(dev, tp_params)
    tp_prefill["launches_a_fused_4_layers"] = tp_fused
    next(r for r in rows if r["name"] == "shift_accumulate")["launches_tp_prefill_fused"] = \
        tp_fused["shift"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 20 (TP prefill over smi:fused): {time.perf_counter() - t0:.1f}s")
    row_d["launches"] = launches_d
    rows.append(row_d)

    t0 = time.perf_counter()
    latency_rows, lat_c = phase_channel_latency(dev)
    torch.cuda.synchronize()
    log(f"phase 21 (channel latency): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    bandwidth_rows, bw_c = phase_channel_bandwidth(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 22 (channel bandwidth): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    gesummv_res = phase_gesummv(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 23 (GESUMMV): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    coll, coll_a = phase_collective_channels(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 24 (collective channels): {time.perf_counter() - t0:.1f}s")
    by_name = {r["name"]: r for r in rows}
    by_name["accumulate"]["launches_channels"] = coll_a["fold"]
    by_name["shift_accumulate"]["launches_channels"] = coll_a["shift"]
    c_warp = next(r for r in rows if r["name"] == "router_run" and r["path"] == "warp")
    c_thread = next(r for r in rows if r["name"] == "router_run" and r["path"] == "thread")
    c_warp["launches_channels"] = lat_c["C_warp"] + bw_c["C_warp"]
    c_thread["launches_channels"] = lat_c["C"] - lat_c["C_warp"] + bw_c["C"] - bw_c["C_warp"]

    t0 = time.perf_counter()
    link_fit = phase_link_fit(dev, reduce_times, injection, bandwidth_rows)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 25 (link model fit): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    tuned, tuned_launches = phase_tuned_collectives(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 26 (tuned collectives and halo): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    tp_auto = phase_tp_auto(dev, tp_params)
    torch.cuda.synchronize()
    log(f"phase 27 (the default TP prefill, plan='auto'): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ring = phase_ring_prefill(dev, tp_params)
    del tp_params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 30 (ring-attention prefill, P = {TP}): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    tp_serving = phase_tp_serving(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 28 (yi-6b served at P = {TP}): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    validate = phase_validate_comm()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 29 (--validate-comm): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches_31, ssm_tp = phase_ssm_tp_prefill(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 31 (mamba2-2.7b TP prefill, P = {TP}): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ssm_tp_serving = phase_ssm_tp_serving(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 32 (mamba2-2.7b served at P = {TP}): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    moe_params, moe_prefill = phase_moe_prefill(dev)
    torch.cuda.synchronize()
    log(f"phase 33 (qwen3-moe-30b-a3b prefill): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches_34, moe_tp = phase_moe_tp_prefill(dev, moe_params)
    del moe_params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    moe_tp["f32"] = phase_moe_f32(dev)
    torch.cuda.synchronize()
    log(f"phase 34 (qwen3-moe-30b-a3b TP prefill, P = {TP}): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    moe_serving = phase_moe_serving(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 35 (qwen3-moe-30b-a3b served at tp = 1 and P = {TP}): "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    validate9 = phase_validate_slice9()
    log(f"phase 36 (--validate-comm, mamba2 and qwen3-moe): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    rg_params, rg_prefill = phase_rg_prefill(dev)
    torch.cuda.synchronize()
    log(f"phase 37 (recurrentgemma-9b prefill): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches_38, rg_tp = phase_rg_tp_prefill(dev, rg_params)
    del rg_params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rg_tp["f32"] = phase_rg_f32(dev)
    torch.cuda.synchronize()
    log(f"phase 38 (recurrentgemma-9b TP prefill, P = {TP}): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    rg_serving = phase_rg_serving(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 39 (recurrentgemma-9b served at tp = 1 and P = {TP}): "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches_40, vlm = phase_vlm(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 40 (internvl2-1b): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches_41, audio = phase_audio(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 41 (musicgen-medium): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    validate10 = phase_validate_slice10()
    log(f"phase 42 (--validate-comm, slice 10): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    grad_kernels = phase_grad_kernels(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 43 (gradients through A, D, E, F): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    train_dense, launches_44 = phase_train_dense(dev)
    torch.cuda.synchronize()
    log(f"phase 44 (yi-6b trained at tp = 1): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    train_tp, launches_45 = phase_train_tp(dev)
    torch.cuda.synchronize()
    log(f"phase 45 (yi-6b trained at P = {TP}): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    train_ssm, launches_46 = phase_train_ssm(dev)
    torch.cuda.synchronize()
    log(f"phase 46 (mamba2-2.7b trained at tp = 1): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    train_launcher = phase_train_launcher()
    log(f"phase 47 (launch.train at tp = 1 and P = {TP}, --validate-comm): "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    train_dp, launches_48 = phase_train_dp(dev)
    torch.cuda.synchronize()
    log(f"phase 48 (yi-6b trained at (2, 4), FSDP): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    train_dp_ssm, launches_49 = phase_train_dp_ssm(dev)
    torch.cuda.synchronize()
    log(f"phase 49 (mamba2-2.7b trained at (2, 4), raw and int8 gradients): "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    remat = phase_remat(dev)
    torch.cuda.synchronize()
    log(f"phase 50 (remat nothing, dots, dots_nb at P = {TP}): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    pipe = phase_pipeline(dev)
    torch.cuda.synchronize()
    log(f"phase 51 (GPipe, {PIPE_STAGES} stages on D): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    validate_dp = phase_validate_dp()
    torch.cuda.synchronize()
    log(f"phase 52 (launch.train and launch.serve at 2,4): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    halo_static = (stencil["overlapped"]["halo_steps"],
                   stencil["overlapped"]["halo_bytes_per_rank"])
    traced_fused = phase_traced_stencil(dev, "smi:fused", halo_static)
    traced_allreduce = phase_traced_allreduce(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 53 (traced stencil over smi:fused, traced all-reduce): "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    traced_packet = phase_traced_stencil(dev, "smi:packet", PACKET_HALO)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 54 (traced stencil over smi:packet): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    lint_capture = phase_lint_capture(dev)
    torch.cuda.synchronize()
    log(f"phase 55 (smilint, yi-6b serve capture at P = {TP}): {time.perf_counter() - t0:.1f}s")
    # phase 56's dry run works on host cores beside phase 58 only: every
    # phase before it has run
    started = start_dryrun()
    t0 = time.perf_counter()
    pod, launches_58 = phase_pod_axis(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 58 (yi-6b trained at {POD_MESH}): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    dry, cut_recs = phase_dryrun(started)
    log(f"phase 56 (the dry run: {len(DRY_CELLS)} cells and phase 57's cuts, done "
        f"{dry['wall_s']:.1f}s after its start): {time.perf_counter() - t0:.1f}s more")
    t0 = time.perf_counter()
    ssm64 = train_ssm[f"bfloat16_{SSM_TRAIN_LAYERS}"]
    dry_vs_card = phase_dry_vs_card(cut_recs, {
        "13": (prefill["state_bytes"], prefill["peak_bytes"], prefill["ms"]),
        "44": (train_dense["state_bytes"], round(train_dense["peak_gb"] * 1e9),
               train_dense["ms_per_step"][-1]),
        "45": (train_tp["state_bytes"], round(train_tp["peak_gb"] * 1e9),
               train_tp["ms_per_step"]["smi:fused"]),
        "46": (ssm64["state_bytes"], round(ssm64["peak_gb"] * 1e9), ssm64["ms_per_step"][-1])})
    log(f"phase 57 (the dry run against the card): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    spmd = phase_spmd(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 59 (ranks as processes, {SPMD_PROCS} on the card): "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    parity, launches_60 = phase_parity(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 60 (parity: the packet data-axis cell, smi:compressed and bulk training, the "
        f"compressed stencil, the examples): {time.perf_counter() - t0:.1f}s")
    # the launches of slice 17's path: a (2, 4) training step's over
    # smi:compressed (60), C's in the packet wire's data-axis cell
    by_name["flash_attention"]["launches_parity_compressed_step"] = launches_60["E"]
    by_name["matmul"]["launches_parity_compressed_step"] = launches_60["D"]
    for name, k in (("accumulate", "fold"), ("shift_accumulate", "shift")):
        by_name[name]["launches_parity_compressed_step"] = launches_60["A"][k]
    c_warp["launches_parity_packet_cell"] = parity["packet_cell"]["launches_c_warp"]
    c_thread["launches_parity_packet_cell"] = (parity["packet_cell"]["launches_c"]
                                               - parity["packet_cell"]["launches_c_warp"])
    # the launches of slice 15's paths, counted in each rank process and
    # summed: B in the first overlapped process-mode launcher run (59 a), A
    # on the fused all-reduces' check runs (59 b, both layouts), where the
    # ring steps fold on the add kernel (the gather cannot see a peer's rows)
    by_name["stencil_sweep"]["launches_process_stencil"] = \
        sum(spmd["stencil"]["overlapped"]["launches_b"][0])
    by_name["accumulate"]["launches_process_allreduce"] = \
        spmd["reductions"]["launches_a_allreduce"]
    by_name["shift_accumulate"]["launches_process_allreduce"] = 0
    # the launches of slice 16's path, counted in each rank process and
    # summed: C's block-tick form in the 8-process packet stencil (59 d, both
    # schedules; its other runs beside), B in its overlapped run
    row_tick = spmd.pop("block_tick_row")
    packet = spmd["packet_stencil"]
    row_tick["launches"] = sum(sum(packet[s]["procs8"]["launches_c"]) for s in packet)
    row_tick["launches_procs2_stencil"] = sum(sum(packet[s]["procs2"]["launches_c"])
                                              for s in packet)
    row_tick["launches_reductions"] = spmd["packet_reductions"]["launches_c"]
    row_tick["launches_latency"] = sum(spmd["latency"]["launches_c"])
    row_tick["launches_reroute"] = spmd["reroute"]["launches_c"]
    rows.append(row_tick)
    by_name["stencil_sweep"]["launches_process_packet_stencil"] = \
        sum(packet["overlapped"]["procs8"]["launches_b"])
    # the launches of slice 14's path: a training step's at (2, 2, 2) over
    # smi:fused (phase 58)
    by_name["flash_attention"]["launches_pod_train_step"] = launches_58["E"]
    by_name["matmul"]["launches_pod_train_step"] = launches_58["D"]
    for name, k in (("accumulate", "fold"), ("shift_accumulate", "shift")):
        by_name[name]["launches_pod_train_step_fused"] = launches_58["A"][k]
    # the launches of slice 13's paths: B in the four launcher runs of each
    # traced stencil (53, 54), C in 54's, A in 53's traced all-reduce; D and
    # E inside phase 55's captured decode step
    by_name["stencil_sweep"]["launches_traced_stencil"] = {
        "smi:fused": traced_fused["launches"]["B"], "smi:packet": traced_packet["launches"]["B"]}
    c_warp["launches_traced_stencil"] = traced_packet["launches"]["C"]
    by_name["shift_accumulate"]["launches_traced_allreduce"] = \
        traced_allreduce["launches"]["shift"]
    inside = lint_capture["serve_capture"]["launches_inside"]
    by_name["matmul"]["launches_captured_serve"] = inside["D"]
    by_name["flash_attention"]["launches_captured_serve"] = inside["E"]
    # the launches of slice 12's paths: a (2, 4) training step's E, D and A
    # (phase 48, both groups), F's and A's on the "grad" ring (phase 49), D's
    # in the remat recompute (phase 50) and in the pipeline's forward (51)
    by_name["flash_attention"]["launches_train_dp_step"] = launches_48["E"]
    by_name["matmul"]["launches_train_dp_step"] = launches_48["D"]
    for name, k in (("accumulate", "fold"), ("shift_accumulate", "shift")):
        by_name[name]["launches_train_dp_step_fused"] = launches_48["A"][k]
    rows_f["wgmma"]["launches_train_dp_step"] = launches_49["F"]
    by_name["shift_accumulate"]["launches_grad_ring"] = launches_49["A_grad_ring"]
    by_name["matmul"]["launches_remat_recompute"] = {k: v["d_recompute"]
                                                     for k, v in remat.items() if k != "differ"}
    by_name["matmul"]["launches_pipeline_forward"] = pipe["d_forward"]
    # a training step's launches, forward, remat recompute and backward
    # together: E in phases 44 and 45, D at P = 8 (its backward's too), A over
    # smi:fused at P = 8, F in phase 46
    by_name["flash_attention"]["launches_train_step"] = launches_44["E"]
    by_name["flash_attention"]["launches_train_tp_step"] = launches_45["E"]
    by_name["matmul"]["launches_train_tp_step"] = launches_45["D"]
    by_name["matmul"]["launches_grad_phase"] = grad_kernels["d_launches"]
    for name, k in (("accumulate", "fold"), ("shift_accumulate", "shift")):
        by_name[name]["launches_train_tp_step_fused"] = launches_45["A"][k]
    rows_f["wgmma"]["launches_train_step"] = launches_46
    # the launches of slice 10's paths: E in phase 37, D and E in the TP
    # prefills of phases 38, 40 and 41 (A over smi:fused), E in the tp = 1
    # prefills of 40 and 41, A a decode step on the tuned wire (39-41)
    by_name["flash_attention"]["launches_rg_prefill"] = rg_prefill["launches_e"]
    for key, launches in (("rg", launches_38), ("vlm", launches_40), ("audio", launches_41)):
        by_name["matmul"][f"launches_{key}_tp_prefill"] = launches["D"]
        by_name["flash_attention"][f"launches_{key}_tp_prefill"] = launches["E"]
        for name, k in (("accumulate", "fold"), ("shift_accumulate", "shift")):
            by_name[name][f"launches_{key}_tp_prefill_fused"] = launches["A"][k]
    for key, res in (("vlm", vlm), ("audio", audio)):
        by_name["flash_attention"][f"launches_{key}_prefill"] = res["launches_e_tp1"]
    for key, res in (("rg", rg_serving), ("vlm", vlm), ("audio", audio)):
        for name, k in (("accumulate", "fold"), ("shift_accumulate", "shift")):
            by_name[name][f"launches_{key}_tp_decode_tuned_per_step"] = \
                res["a_per_step_tuned_runs"][k]
    # the launches of slice 9's paths: F and D in phase 31, E in phase 33, D
    # and E in phase 34 (A over smi:fused), A a decode step on the tuned wire
    # in phases 32 and 35
    rows_f["wgmma"]["launches_ssm_tp_prefill"] = launches_31["F"]
    by_name["matmul"]["launches_ssm_tp_prefill"] = launches_31["D"]
    by_name["matmul"]["launches_moe_tp_prefill"] = launches_34["D"]
    by_name["flash_attention"]["launches_moe_prefill"] = moe_prefill["launches_e"]
    by_name["flash_attention"]["launches_moe_tp_prefill"] = launches_34["E"]
    for name, key in (("accumulate", "fold"), ("shift_accumulate", "shift")):
        by_name[name]["launches_moe_tp_prefill_fused"] = launches_34["A"][key]
        by_name[name]["launches_ssm_tp_decode_tuned_per_step"] = \
            ssm_tp_serving["a_per_step_tuned_runs"][key]
        by_name[name]["launches_moe_tp_decode_tuned_per_step"] = \
            moe_serving["a_per_step_tuned_runs"][key]
    for key, res in (("ssm", ssm_tp_serving), ("moe", moe_serving), ("rg", rg_serving),
                     ("vlm", vlm), ("audio", audio)):
        by_name["shift_accumulate"][f"launches_{key}_tp_decode_fused_per_step"] = \
            res["fused_vs_static"]["a_launches_per_step"]

    # each kernel's launches on the tuned paths: the checked phase 26 runs
    # and phase 27's timed-before prefill
    lt = tp_auto["launches"]
    by_name["accumulate"]["launches_tuned"] = tuned_launches["A_fold"] + lt["A_fold"]
    by_name["shift_accumulate"]["launches_tuned"] = tuned_launches["A_shift"] + lt["A_shift"]
    by_name["stencil_sweep"]["launches_tuned"] = tuned_launches["B"]
    by_name["matmul"]["launches_tuned"] = lt["D"]
    by_name["flash_attention"]["launches_tuned"] = lt["E"]
    # kernel A on the TP decode path: its launches a decode step in phase 28's
    # launcher runs on the tuned wire, and the fused wire's in one validated
    # step (phase 29)
    for name, key in (("accumulate", "fold"), ("shift_accumulate", "shift")):
        by_name[name]["launches_tp_decode_tuned_per_step"] = \
            tp_serving["a_per_step_tuned_runs"][key]
        by_name[name]["launches_tp_decode_fused_step"] = {
            k: v["A"][key] for k, v in validate.items() if k.endswith("smi:fused")}

    log("stencil_wall_per_step_ms: " + json.dumps(
        {k: v["wall_per_step_s"] * 1e3 for k, v in stencil.items()}))
    log("packet_stencil_wall_per_step_ms: " + json.dumps(
        {k: v["wall_per_step_s"] * 1e3 for k, v in packet_stencil.items()}))
    log("packet_stencil_profile: " + json.dumps(packet_profile))
    log("reductions_static_vs_fused_ms: " + json.dumps(reduce_times))
    log("injection_tab4: " + json.dumps(injection))
    log("prefill_yi6b_4096: " + json.dumps(prefill))
    for name, res in (("serving_yi6b", serving), ("serving_mamba2", ssm_serving)):
        log(f"{name}: " + json.dumps({k: {m: v[m] for m in ("tok_per_s", "ms_per_step",
                                                              "decode_steps", "tokens")}
                                      for k, v in res.items()}))
    log("prefill_mamba2_4096: " + json.dumps(ssm_prefill))
    log("tp_prefill_yi6b_4096_p8: " + json.dumps(tp_prefill))
    log("channel_latency: " + json.dumps(latency_rows))
    log("channel_bandwidth: " + json.dumps(bandwidth_rows))
    log("gesummv: " + json.dumps(gesummv_res))
    log("collective_channels: " + json.dumps(coll))
    log("link_fit: " + json.dumps(link_fit))
    log("tuned_collectives: " + json.dumps(tuned))
    log("tp_prefill_auto: " + json.dumps(tp_auto))
    log("tp_serving_yi6b_p8: " + json.dumps(tp_serving))
    log("validate_comm: " + json.dumps({k: v["A"] for k, v in validate.items()}))
    log("ring_prefill_yi6b_4096_p8: " + json.dumps(ring))
    log("tp_prefill_mamba2_4096_p8: " + json.dumps(ssm_tp))
    log("tp_serving_mamba2_p8: " + json.dumps(ssm_tp_serving))
    log("prefill_qwen3moe_4096: " + json.dumps(moe_prefill))
    log("tp_prefill_qwen3moe_4096_p8: " + json.dumps(moe_tp))
    log("serving_qwen3moe: " + json.dumps(moe_serving))
    log("validate_comm_slice9: " + json.dumps({k: sum(e["bytes"] for e in v.values())
                                               for k, v in validate9.items()}))
    log("prefill_recurrentgemma_4096: " + json.dumps(rg_prefill))
    log("tp_prefill_recurrentgemma_4096_p8: " + json.dumps(rg_tp))
    log("serving_recurrentgemma: " + json.dumps(rg_serving))
    log("internvl2_1b: " + json.dumps(vlm))
    log("musicgen_medium: " + json.dumps(audio))
    log("validate_comm_slice10: " + json.dumps({k: sum(e["bytes"] for e in v.values())
                                                for k, v in validate10.items()}))
    log("grad_kernels: " + json.dumps(grad_kernels))
    log("train_yi6b_tp1: " + json.dumps(train_dense))
    log("train_yi6b_p8: " + json.dumps(train_tp))
    log("train_mamba2_tp1: " + json.dumps(train_ssm))
    log("train_launcher: " + json.dumps(train_launcher))
    log("train_yi6b_dp2_tp4: " + json.dumps(train_dp))
    log("train_mamba2_dp2_tp4: " + json.dumps(train_dp_ssm))
    log("remat_p8: " + json.dumps(remat))
    log("pipeline: " + json.dumps(pipe))
    log("validate_dp: " + json.dumps(validate_dp))
    log("traced_stencil: " + json.dumps({"smi:fused": traced_fused, "smi:packet": traced_packet,
                                         "allreduce": traced_allreduce}))
    log("lint_capture: " + json.dumps(lint_capture))
    log("dryrun: " + json.dumps(dry))
    log("dryrun_vs_card: " + json.dumps(dry_vs_card))
    log("pod_axis: " + json.dumps(pod))
    log("ranks_as_processes: " + json.dumps(spmd))
    log("parity: " + json.dumps(parity))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
