// Kernel C: a whole run of the store-and-forward packet router, every tick
// of every rank, in one launch.
//
// Replaces the Pallas kernel `router_tick_pallas` of
// src/repro/kernels/router/kernel.py, which runs ONE tick of ONE rank per
// pallas_call with the router state aliased in VMEM, inside a lax.scan whose
// exchange between ticks is an all_to_all outside the kernel.  Here all P
// ranks live in one device's memory, so the exchange is a read of a
// neighbour's send slot, and one thread block runs the loop over ticks with
// __syncthreads() between the phases of a tick (a loop inside the block in
// place of the sequential grid).  It computes exactly what
// kernels/router/ref.py:router_run_ref computes:
//
//   absorb (ticks t > 0, labelled t - 1)  one thread per rank walks its
//       arrivals in link order: deliver (dst == rank) into the next slot of
//       its port, or park at the transit tail; past out_cap / transit_cap the
//       packet drops and counts in overflow.  Sequential in link order, this
//       gives the reference's exclusive-prefix-sum slots.  It only records
//       which payload goes where.
//   payload copy  all threads copy the recorded payload rows, 16 bytes a
//       thread where the packet is a multiple of 4 words, as 32-bit words
//       (never through float arithmetic, so any bit pattern survives).
//   arbitrate (tick t)  one thread per rank: one masked rotated argmax per
//       link (transit first, then R-stickiness, then the switch bubble), the
//       pops, and a send descriptor per (rank, link): valid, dst, port and a
//       pointer to the payload, which stays where it is (a FIFO slot of the
//       staged input or a transit slot).  The receiver on link li of rank r
//       reads the descriptor of src[r, li] at its next absorb: no copy and
//       no collective for the exchange.
//   drain  __syncthreads_count of the ranks with work left; the loop ends
//       when it is 0 (every later tick would be identity) and never runs
//       past n_steps.
//
// The transit ring has transit_cap + 1 slots although it holds at most
// transit_cap packets: a slot popped at tick t is read by its receiver at
// tick t + 1 while the same rank parks new arrivals, and one spare slot keeps
// those writes off it (a rank pops at most one transit packet a tick).
//
// Bound on an H100: neither bytes nor operations but the chain of n_steps
// dependent ticks, each a few barriers and a few dependent loads (the
// staged FIFO heads and the transit ring in device memory); the payload a
// tick moves is at most P * NL packets.  Control state (heads, counts, the
// arbiter latches, the route table, the send descriptors) stays in shared
// memory for the whole run.  Fanning out over a thread-block cluster (one
// CTA per rank, the exchange through distributed shared memory) is later
// work.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxSrcs = 16;  // arbitration candidates: n_ports + 1

struct Args {
  const uint32_t* inq_pay;  // (P, NP, FC, E) staged payload words
  const int* inq_dst;       // (P, NP, FC)
  const int* inq_len;       // (P, NP)
  const int* route_tbl;     // (P, P) link id of the first hop r -> d
  const int* src_tbl;       // (P, NL) rank whose link-li packet lands on r
  const int* link_ids;      // (NL,)
  uint32_t* out_pay;        // (P, NP, OC, E), zero on entry
  int* out_cnt;             // (P, NP)
  int* overflow;            // (P,)
  int* t_done;              // (P,)
  int* ticks;               // (1,) ticks run
  uint32_t* tr_pay;         // (P, TC + 1, E) scratch
  int* tr_ctl;              // (2, P, TC + 1) scratch: dst, port
  int P, NP, FC, TC, OC, E, NL, R, bubble, n_steps, vec4;
};

struct Shared {
  const uint32_t** snd_pay;  // (P*NL) payload of the packet sent on (r, li)
  const uint32_t** cp_src;   // (P*NL) payload copies of this tick's absorb
  uint32_t** cp_dst;
  int *inq_head, *inq_len, *out_cnt;          // (P*NP)
  int *tr_head, *tr_cnt, *ovf, *tdone;        // (P)
  int *last_src, *stick, *src, *snd_val, *snd_dst, *snd_prt;  // (P*NL)
  int *lids;                                  // (NL)
  int *tbl;                                   // (P*P)
};

__device__ void absorb(const Args& a, const Shared& s, int r, int label) {
  const int PC = a.TC + 1;
  for (int li = 0; li < a.NL; ++li) {
    const int c = r * a.NL + li;
    s.cp_src[c] = nullptr;
    const int k = s.src[c] * a.NL + li;  // the neighbour's send slot
    if (!s.snd_val[k]) continue;
    const int dst = s.snd_dst[k], prt = s.snd_prt[k];
    if (dst == r) {
      const int p = min(max(prt, 0), a.NP - 1);
      const int slot = s.out_cnt[r * a.NP + p];
      if (slot < a.OC) {
        s.cp_src[c] = s.snd_pay[k];
        s.cp_dst[c] = a.out_pay + ((static_cast<int64_t>(r) * a.NP + p) * a.OC + slot) * a.E;
        s.out_cnt[r * a.NP + p] = slot + 1;
        s.tdone[r] = label;
      } else {
        s.ovf[r] += 1;
      }
    } else if (s.tr_cnt[r] < a.TC) {
      const int pos = (s.tr_head[r] + s.tr_cnt[r]) % PC;
      s.cp_src[c] = s.snd_pay[k];
      s.cp_dst[c] = a.tr_pay + (static_cast<int64_t>(r) * PC + pos) * a.E;
      a.tr_ctl[r * PC + pos] = dst;
      a.tr_ctl[(a.P + r) * PC + pos] = prt;
      s.tr_cnt[r] += 1;
    } else {
      s.ovf[r] += 1;
    }
  }
}

__device__ void copy_payloads(const Args& a, const Shared& s) {
  const int n = a.P * a.NL;
  if (a.vec4) {
    const int w4 = a.E / 4;
    for (int i = threadIdx.x; i < n * w4; i += blockDim.x) {
      const int c = i / w4;
      const uint32_t* src = s.cp_src[c];
      if (src) {
        const int w = i - c * w4;
        reinterpret_cast<uint4*>(s.cp_dst[c])[w] = reinterpret_cast<const uint4*>(src)[w];
      }
    }
  } else {
    for (int i = threadIdx.x; i < n * a.E; i += blockDim.x) {
      const int c = i / a.E;
      const uint32_t* src = s.cp_src[c];
      if (src) s.cp_dst[c][i - c * a.E] = src[i - c * a.E];
    }
  }
}

// Returns the rank's remaining work: staged + parked + sent this tick.
__device__ int arbitrate(const Args& a, const Shared& s, int r) {
  const int S = a.NP + 1, PC = a.TC + 1;
  int cdst[kMaxSrcs], cprt[kMaxSrcs], cwant[kMaxSrcs];
  const uint32_t* cpay[kMaxSrcs];
  unsigned has = 0;
  for (int p = 0; p < a.NP; ++p) {
    const int h = s.inq_head[r * a.NP + p];
    const int64_t row = (static_cast<int64_t>(r) * a.NP + p) * a.FC + min(h, a.FC - 1);
    if (h < s.inq_len[r * a.NP + p]) has |= 1u << p;
    cdst[p] = a.inq_dst[row];
    cprt[p] = p;
    cpay[p] = a.inq_pay + row * a.E;
  }
  const int th = s.tr_head[r] % PC;
  if (s.tr_cnt[r] > 0) {
    has |= 1u << (S - 1);
    cdst[S - 1] = a.tr_ctl[r * PC + th];
    cprt[S - 1] = a.tr_ctl[(a.P + r) * PC + th];
  } else {
    cdst[S - 1] = 0;
    cprt[S - 1] = 0;
  }
  cpay[S - 1] = a.tr_pay + (static_cast<int64_t>(r) * PC + th) * a.E;
  for (int c = 0; c < S; ++c) {
    const int d = min(max(cdst[c], 0), a.P - 1);
    cwant[c] = cdst[c] == r ? -2 : s.tbl[r * a.P + d];
  }

  int sent = 0;
  for (int li = 0; li < a.NL; ++li) {
    const int k = r * a.NL + li, lid = s.lids[li];
    unsigned avail = 0;
    for (int c = 0; c < S; ++c)
      if (((has >> c) & 1u) && cwant[c] == lid) avail |= 1u << c;
    const int last = s.last_src[k];
    const bool tr_want = (avail >> (S - 1)) & 1u;
    const bool keep = s.stick[k] < a.R && ((avail >> min(max(last, 0), S - 1)) & 1u);
    int rr = (last + 1) % S;  // argmax of an all-false row picks its first entry
    for (int j = 0; j < S; ++j) {
      const int c = (last + 1 + j) % S;
      if ((avail >> c) & 1u) { rr = c; break; }
    }
    const int chosen = tr_want ? S - 1 : (keep ? last : rr);
    const bool any = avail != 0;
    const bool send = a.bubble ? (any && chosen == last) : any;
    s.last_src[k] = any ? chosen : last;
    s.stick[k] = (send && chosen == last) ? s.stick[k] + 1 : 0;
    s.snd_val[k] = send;
    if (send) {
      if (chosen < a.NP) {
        s.inq_head[r * a.NP + chosen] += 1;
      } else {
        s.tr_head[r] += 1;
        s.tr_cnt[r] -= 1;
      }
      s.snd_dst[k] = cdst[chosen];
      s.snd_prt[k] = cprt[chosen];
      s.snd_pay[k] = cpay[chosen];
      ++sent;
    } else {
      s.snd_dst[k] = -1;
      s.snd_prt[k] = 0;
      s.snd_pay[k] = nullptr;
    }
  }
  int pending = s.tr_cnt[r] + sent;
  for (int p = 0; p < a.NP; ++p) pending += s.inq_len[r * a.NP + p] - s.inq_head[r * a.NP + p];
  return pending;
}

template <typename T>
__device__ T* carve(unsigned char*& p, int n) {
  T* out = reinterpret_cast<T*>(p);
  p += static_cast<size_t>(n) * sizeof(T);
  return out;
}

__device__ __host__ size_t shared_bytes(int P, int NP, int NL) {
  return 3 * static_cast<size_t>(P) * NL * sizeof(void*) +
         (3 * static_cast<size_t>(P) * NP + 4 * P + 6 * static_cast<size_t>(P) * NL + NL +
          static_cast<size_t>(P) * P) * sizeof(int);
}

__global__ void router_run_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  Shared s;
  const int PNP = a.P * a.NP, PNL = a.P * a.NL;
  s.snd_pay = carve<const uint32_t*>(p, PNL);
  s.cp_src = carve<const uint32_t*>(p, PNL);
  s.cp_dst = carve<uint32_t*>(p, PNL);
  s.inq_head = carve<int>(p, PNP);
  s.inq_len = carve<int>(p, PNP);
  s.out_cnt = carve<int>(p, PNP);
  s.tr_head = carve<int>(p, a.P);
  s.tr_cnt = carve<int>(p, a.P);
  s.ovf = carve<int>(p, a.P);
  s.tdone = carve<int>(p, a.P);
  s.last_src = carve<int>(p, PNL);
  s.stick = carve<int>(p, PNL);
  s.src = carve<int>(p, PNL);
  s.snd_val = carve<int>(p, PNL);
  s.snd_dst = carve<int>(p, PNL);
  s.snd_prt = carve<int>(p, PNL);
  s.lids = carve<int>(p, a.NL);
  s.tbl = carve<int>(p, a.P * a.P);

  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < PNP; i += nt) {
    s.inq_head[i] = 0;
    s.inq_len[i] = a.inq_len[i];
    s.out_cnt[i] = 0;
  }
  for (int i = tid; i < a.P; i += nt) s.tr_head[i] = s.tr_cnt[i] = s.ovf[i] = s.tdone[i] = 0;
  for (int i = tid; i < PNL; i += nt) {
    s.last_src[i] = s.stick[i] = s.snd_val[i] = 0;
    s.src[i] = a.src_tbl[i];
    s.cp_src[i] = nullptr;
  }
  for (int i = tid; i < a.NL; i += nt) s.lids[i] = a.link_ids[i];
  for (int i = tid; i < a.P * a.P; i += nt) s.tbl[i] = a.route_tbl[i];
  __syncthreads();

  int ran = 0;
  for (int t = 0; t < a.n_steps; ++t) {
    if (t > 0) {
      for (int r = tid; r < a.P; r += nt) absorb(a, s, r, t - 1);
      __syncthreads();
      // arbitrate touches neither the copy list nor any payload, so the
      // copies and this tick's arbitration need no barrier between them
      copy_payloads(a, s);
    }
    int pending = 0;
    for (int r = tid; r < a.P; r += nt) pending += arbitrate(a, s, r);
    ran = t + 1;
    if (__syncthreads_count(pending > 0) == 0) break;
  }
  // the last tick's sends are still in flight at loop exit
  if (ran > 0) {
    for (int r = tid; r < a.P; r += nt) absorb(a, s, r, ran - 1);
    __syncthreads();
    copy_payloads(a, s);
  }
  __syncthreads();
  for (int i = tid; i < PNP; i += nt) a.out_cnt[i] = s.out_cnt[i];
  for (int i = tid; i < a.P; i += nt) {
    a.overflow[i] = s.ovf[i];
    a.t_done[i] = s.tdone[i];
  }
  if (tid == 0) a.ticks[0] = ran;
}

}  // namespace

// One launch of one block runs the whole router.  Returns the CUDA error of
// the launch (0 on success); cudaErrorInvalidValue when n_ports + 1 exceeds
// the candidate limit or the shared memory exceeds what a block can have.
extern "C" int smi_router_run(const void* inq_pay, const void* inq_dst, const void* inq_len,
                              const void* route_tbl, const void* src_tbl, const void* link_ids,
                              void* out_pay, void* out_cnt, void* overflow, void* t_done,
                              void* ticks, void* tr_pay, void* tr_ctl, int P, int NP, int FC,
                              int TC, int OC, int E, int NL, int R, int bubble, int n_steps,
                              int threads, void* stream) {
  if (NP + 1 > kMaxSrcs || P < 1 || NP < 1 || FC < 1 || TC < 1 || E < 1 || NL < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const uint32_t*>(inq_pay), static_cast<const int*>(inq_dst),
         static_cast<const int*>(inq_len), static_cast<const int*>(route_tbl),
         static_cast<const int*>(src_tbl), static_cast<const int*>(link_ids),
         static_cast<uint32_t*>(out_pay), static_cast<int*>(out_cnt),
         static_cast<int*>(overflow), static_cast<int*>(t_done), static_cast<int*>(ticks),
         static_cast<uint32_t*>(tr_pay), static_cast<int*>(tr_ctl),
         P, NP, FC, TC, OC, E, NL, R, bubble, n_steps, 0};
  const uintptr_t align = reinterpret_cast<uintptr_t>(inq_pay) |
                          reinterpret_cast<uintptr_t>(out_pay) |
                          reinterpret_cast<uintptr_t>(tr_pay);
  a.vec4 = (E % 4 == 0) && (align % 16 == 0);
  const size_t smem = shared_bytes(P, NP, NL);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(router_run_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  router_run_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
