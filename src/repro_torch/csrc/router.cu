// Kernel C: a whole run of the store-and-forward packet router, every tick
// of every rank, in one launch; and, for ranks run as processes, one tick of
// a block of ranks a launch (the block-tick form, at the end of this file).
//
// Replaces the Pallas kernel `router_tick_pallas` of
// src/repro/kernels/router/kernel.py, which runs ONE tick of ONE rank per
// pallas_call with the router state aliased in VMEM, inside a lax.scan whose
// exchange between ticks is an all_to_all outside the kernel.  Here all P
// ranks live in one device's memory, so the exchange is a read of a
// neighbour's send slot, and one thread block runs the loop over ticks (a
// loop inside the block in place of the sequential grid).  Both kernels
// below compute exactly what kernels/router/ref.py:router_run_ref computes;
// the wrapper (kernels/router/kernel.py:router_path) picks one by shape.
//
// Bound on an H100: neither bytes nor operations but the chain of n_steps
// dependent ticks; the payload a tick moves is at most P * NL packets.
//
// == The warp path (smi_router_run_warp): a rank on a warp's lanes, P <= 32 ==
//
// A tick is a chain of shared-memory and warp operations ending in one
// block barrier; nothing in device memory is read on it.
//   * Lanes: a rank takes L lanes, the power of two that holds its
//     candidates (the NP FIFO heads and the transit head) and its NL links,
//     and a warp holds 32 / L ranks (8 at the halo shape, L = 4), so warp
//     operations act on all of a warp's ranks at once, each rank on its own
//     segment of the masks.  Each warp of ranks has a twin that handles the
//     same ranks' deliveries, which nothing in a tick waits for.
//   * A packet is named by its origin, its row in the staged input, and
//     travels as one 32-bit word: the origin, its destination (clamped, plus
//     a bit for a destination outside [0, P)) and its port.  A packet's
//     payload never changes in flight, so the payload stays where it was
//     staged: a delivery records the origin of its output slot (`org`,
//     written to device memory and never read back during the run), and a
//     second kernel copies each delivered row from the staged input once,
//     after the run, and zeroes the empty slots.  No transit payload ring
//     exists, and no spare slot.
//   * Shared memory holds the staged headers, a byte a packet (destination
//     and the out-of-range bit; the origin is the byte's position), the
//     transit rings (transit_cap origins a rank, 16 bits each while the
//     staged packets number at most 2^16), the send slots (double-buffered
//     by tick parity, so one barrier a tick separates the sends of tick t
//     from their reads at tick t + 1 and from the overwrite at tick t + 2)
//     and the route table as link indices.
//   * Lane c < NP of a rank holds FIFO c's head and length in registers,
//     lane NP reads the transit head; lane l < NL holds link l's arbiter
//     latches (last source, stickiness) and the rank that feeds it.  A
//     candidate changes only by a pop (or a park into an empty transit
//     ring), so each tick reads the next tick's candidates after its pops.
//   * absorb: lane l reads its arrival; deliveries take slot out_cnt[port] +
//     the rank's earlier lanes delivering to the same port (one
//     __ballot_sync and __popc a port; __match_any_sync, which the ballots
//     replace, is far slower), parks take the transit tail + the earlier
//     parking lanes: the reference's exclusive prefix sums in link order,
//     with the overflow past out_cap / transit_cap in that order.
//   * arbitrate: each candidate wants exactly one link, so the links
//     arbitrate over disjoint candidate sets: one ballot per link gives its
//     availability mask, and lane l runs the masked rotated argmax (transit
//     first, R-stickiness, switch bubble) on its bits; the chosen word and
//     the pops come over __shfl_sync.
//   * drain: a named barrier over the ranks' warps counts the lanes with
//     work left and ends the loop once it is 0, never past n_steps.
//
// == The thread path (smi_router_run): one thread per rank, any P ==
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
// Its transit ring has transit_cap + 1 slots although it holds at most
// transit_cap packets: a slot popped at tick t is read by its receiver at
// tick t + 1 while the same rank parks new arrivals, and one spare slot keeps
// those writes off it (a rank pops at most one transit packet a tick).  Its
// control state (heads, counts, the arbiter latches, the route table, the
// send descriptors) stays in shared memory; the staged FIFO heads, the
// transit ring and the payload copies sit in device memory on its chain.
#include <cuda_runtime.h>
#include <algorithm>
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

// ---------------------------------------------------------------------------
// The warp path: a rank on a warp's lanes (see the note at the top of this file).
// ---------------------------------------------------------------------------

namespace {

constexpr unsigned kFull = 0xffffffffu;
// a packet word (send slots): bits [0, 5) port, [5, 10) destination clamped
// to [0, P), bit 10 set when the destination lies outside [0, P), [11, 31)
// the origin (row of the staged input); valid words are >= 0, an empty slot
// is -1.  A staged header keeps bits [5, 11) of it in a byte: the origin is
// its position and the port follows from the origin.
constexpr int kDstShift = 5, kOobBit = 10, kOrgShift = 11;
// threads of the warp path's block: all of them stage the headers, the
// first 2 * ceil(P / (32 / L)) warps run the ticks
constexpr int kWarpBlock = 1024;

struct WarpArgs {
  const int* inq_dst;    // (P, NP, FC)
  const int* inq_len;    // (P, NP)
  const int* route_tbl;  // (P, P) link id of the first hop r -> d
  const int* src_tbl;    // (P, NL) rank whose link-li packet lands on r
  const int* link_ids;   // (NL,) distinct
  int* org;              // (P, NP, OC) origin of each delivered packet
  int* out_cnt;          // (P, NP)
  int* overflow;         // (P,)
  int* t_done;           // (P,)
  int* ticks;            // (1,) ticks run
  int P, NP, FC, TC, OC, NL, R, bubble, n_steps;
  int L;                 // lanes a rank: a power of two >= max(NL, NP + 1)
};

// named barrier 1 over the first n threads of the block (a multiple of 32):
// returns how many of them passed pred
__device__ __forceinline__ int tick_barrier(int n, bool pred) {
  int count;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\tbar.red.popc.u32 %0, 1, %1, p;\n\t}"
      : "=r"(count)
      : "r"(n), "r"(static_cast<unsigned>(pred))
      : "memory");
  return count;
}

// RingT holds an origin in the transit rings: uint16_t while the staged
// packets number at most 2^16 (half the shared memory), else uint32_t
template <typename RingT>
__global__ void router_warp_kernel(WarpArgs a) {
  extern __shared__ __align__(16) int sm[];
  const int P = a.P, NP = a.NP, NL = a.NL, FC = a.FC, TC = a.TC, OC = a.OC, S = NP + 1;
  int* snd = sm;                     // (2, P, NL) send slots by tick parity
  int* lidx = snd + 2 * P * NL;      // (P, P) link index of the first hop, -1: none
  int* del_ovf = lidx + P * P;       // (P,) the deliveries' overflow
  RingT* ring = reinterpret_cast<RingT*>(del_ovf + P);  // (P, TC) transit origins
  unsigned char* hdr = reinterpret_cast<unsigned char*>(ring + P * TC);  // (P, NP, FC)
  const int tid = threadIdx.x, nt = blockDim.x;
#pragma unroll 8
  for (int i = tid; i < P * NP * FC; i += nt) {
    const int d = a.inq_dst[i], dc = min(max(d, 0), P - 1);
    hdr[i] = static_cast<unsigned char>((static_cast<int>(d != dc) << (kOobBit - kDstShift)) | dc);
  }
  for (int i = tid; i < 2 * P * NL; i += nt) snd[i] = -1;
  for (int i = tid; i < P * P; i += nt) {
    const int lid = a.route_tbl[i];
    int li = -1;
    for (int j = 0; j < NL; ++j)
      if (a.link_ids[j] == lid) li = j;
    lidx[i] = li;
  }

  // a rank's lanes: L of them (a power of two, at least its candidates and
  // its links), 32 / L ranks a warp; lane sl of rank r is lane seg + sl.
  // The first `group` threads run the ranks' control (parks, arbitration),
  // the next `group` the same ranks' deliveries, which nothing in a tick
  // waits for; the rest of the block only staged the headers.
  const int L = a.L, group = 32 * ((P + 32 / L - 1) / (32 / L));
  const bool delivers = tid >= group;
  const int gt = delivers ? tid - group : tid;
  const int lane = gt & 31, sl = lane & (L - 1), seg = lane - sl;
  const int r = (gt >> 5) * (32 / L) + lane / L;
  const bool live = r < P;  // the last warp's spare lanes hold no rank
  const unsigned segmask = L == 32 ? kFull : ((1u << L) - 1u) << seg;
  const unsigned lt = ((1u << lane) - 1u) & segmask;  // the rank's lanes before this one
  const bool is_link = live && sl < NL, is_fifo = live && sl < NP, is_tr = live && sl == NP;
  const int feeder = is_link ? a.src_tbl[r * NL + sl] : 0;
  const int fifo_base = is_fifo ? (r * NP + sl) * FC : 0;
  const int len = is_fifo && !delivers ? a.inq_len[r * NP + sl] : 0;
  int* org = a.org + static_cast<int64_t>(live ? r : 0) * NP * OC;  // the rank's (NP, OC)
  int last = 0, stick = 0;  // control, link lanes: the arbiter latches
  int head = 0;             // control, lane c < NP: FIFO c's head
  // deliveries, lane p < NP: port p's delivery count (with one port, every
  // lane of the rank holds it)
  int out_cnt = 0, tdone = 0;
  int tr_head = 0, tr_cnt = 0, ovf = 0;  // the same in every lane of a rank
  __syncthreads();
  if (tid >= 2 * group) return;

  // control: the candidate of this lane (lane c < NP the head of FIFO c,
  // lane NP the transit head): its packet word and the link it wants (-1:
  // none)
  int w = 0, want = -1;
  auto candidate = [&]() {
    int origin = 0, port = 0;
    bool has = false;
    if (is_fifo) {
      has = head < len;
      origin = fifo_base + min(head, FC - 1);
      port = sl;
    } else if (is_tr && tr_cnt > 0) {
      has = true;
      origin = ring[r * TC + tr_head];
      port = NP == 1 ? 0 : origin / FC % NP;
    }
    const int h = hdr[origin];
    w = (origin << kOrgShift) | (h << kDstShift) | port;
    const bool local = !(h >> (kOobBit - kDstShift)) && (h & 31) == r;
    want = has && !local ? lidx[r * P + (h & 31)] : -1;
  };

  // the arrival on this lane's link from the tick whose sends are `in`, and
  // whether it is delivered here
  auto arrival = [&](const int* in, bool& mine) {
    const int v = is_link ? in[feeder * NL + sl] : -1;
    mine = v >= 0 && !((v >> kOobBit) & 1) && ((v >> kDstShift) & 31) == r;
    return v;
  };

  // deliveries of the arrivals labelled `label`: slot = out_cnt[port] + the
  // rank's earlier lanes delivering to the port; the first OC - out_cnt of
  // a port's arrivals land, the rest count as overflow
  auto deliver = [&](int label, const int* in) {
    bool mine;
    const int v = arrival(in, mine);
    const int prt = v & 31;
    const unsigned minem = __ballot_sync(kFull, mine) & segmask;
    int slot = 0, landed = 0;
    if (NP == 1) {
      slot = out_cnt + __popc(minem & lt);
      landed = min(__popc(minem), max(OC - out_cnt, 0));
      out_cnt += landed;
      ovf += __popc(minem) - landed;
    } else {
      for (int p = 0; p < NP; ++p) {
        const unsigned grp = __ballot_sync(kFull, mine && prt == p) & segmask;
        const int base = __shfl_sync(kFull, out_cnt, p, L);
        const int fill = min(__popc(grp), max(OC - base, 0));
        if ((grp >> lane) & 1u) slot = base + __popc(grp & lt);
        if (sl == p) out_cnt = base + fill;
        landed += fill;
        ovf += __popc(grp) - fill;
      }
    }
    if (mine && slot < OC) org[prt * OC + slot] = v >> kOrgShift;
    if (landed) tdone = label;
  };

  // control: parks of the same arrivals: tail = head + count + the rank's
  // earlier parking lanes, while there is room; the first TC - tr_cnt
  // forwarded arrivals park, the rest count as overflow
  auto park = [&](const int* in) {
    bool mine;
    const int v = arrival(in, mine);
    const bool fwd = v >= 0 && !mine;
    const unsigned fwdm = __ballot_sync(kFull, fwd) & segmask;
    const int off = __popc(fwdm & lt);
    if (fwd && tr_cnt + off < TC) {
      const int pos = tr_head + tr_cnt + off;
      ring[r * TC + (pos >= TC ? pos - TC : pos)] = static_cast<RingT>(v >> kOrgShift);
    }
    const int parks = min(__popc(fwdm), max(TC - tr_cnt, 0));
    tr_cnt += parks;
    ovf += __popc(fwdm) - parks;
  };

  // control: this tick's sends into slots `out`, the pops, and the next
  // tick's candidates; returns whether this lane sees work left on its rank
  // (a staged packet of its FIFO; lane 0: a parked packet or a send)
  auto arbitrate = [&](int* out) -> bool {
    unsigned avail = 0;  // link lanes: the candidates that want this link
    for (int li = 0; li < NL; ++li) {
      const unsigned m = __ballot_sync(kFull, want == li);
      if (sl == li) avail = (m & segmask) >> seg;
    }
    // every lane runs the link arbiter; lanes past NL see no candidate
    const unsigned maskS = S >= 32 ? kFull : (1u << S) - 1u;
    const bool tr_want = (avail >> NP) & 1u;
    const bool keep = stick < a.R && ((avail >> min(max(last, 0), S - 1)) & 1u);
    const int s0 = last + 1 >= S ? 0 : last + 1;  // (last + 1) % S
    // the rotation starting at s0: bit j is candidate (s0 + j) % S
    const unsigned rot = ((avail >> s0) | (s0 ? avail << (S - s0) : 0u)) & maskS;
    int rr = s0;  // argmax of an all-false row picks its first entry
    if (rot) {
      rr = s0 + __ffs(rot) - 1;
      if (rr >= S) rr -= S;
    }
    const int chosen = tr_want ? NP : (keep ? last : rr);
    const bool any = avail != 0;
    const bool send = a.bubble ? (any && chosen == last) : any;
    stick = (send && chosen == last) ? stick + 1 : 0;
    last = any ? chosen : last;
    const int sel = __shfl_sync(kFull, w, chosen, L);
    if (is_link) out[r * NL + sl] = send ? sel : -1;
    // a candidate wants one link: it is popped when that link sent it
    const int taken = __shfl_sync(kFull, send ? chosen : -1, want >= 0 ? want : 0, L);
    const bool popped = want >= 0 && taken == sl;
    const unsigned pops = __ballot_sync(kFull, popped) & segmask;
    if (is_fifo && popped) ++head;
    if ((pops >> (seg + NP)) & 1u) {
      tr_head = tr_head + 1 == TC ? 0 : tr_head + 1;
      --tr_cnt;
    }
    __syncwarp();  // this tick's parks are in the ring before the next head is read
    candidate();
    return (is_fifo && head < len) || (live && sl == 0 && (tr_cnt > 0 || pops != 0));
  };

  // A FIFO head changes only by a pop and the transit head by a pop or a
  // park into an empty ring, so each tick's candidates are read at the end
  // of the tick before, and again after the parks only when they filled an
  // empty ring.  The sends of tick t are read at tick t + 1 and overwritten
  // at tick t + 2, after the barrier that ends tick t + 1.
  if (!delivers) candidate();
  int ran = 0;
  for (int t = 0; t < a.n_steps; ++t) {
    const int* in = snd + ((t - 1) & 1) * P * NL;
    bool busy = false;
    if (delivers) {
      if (t > 0) deliver(t - 1, in);
    } else {
      if (t > 0) {
        const bool was_empty = tr_cnt == 0;
        park(in);
        if (__any_sync(kFull, was_empty && tr_cnt > 0)) {
          __syncwarp();  // the parks are in the ring before the transit head is read
          candidate();
        }
      }
      busy = arbitrate(snd + (t & 1) * P * NL);
    }
    ran = t + 1;
    if (tick_barrier(2 * group, busy) == 0) break;
  }
  // the last tick's sends are still in flight at loop exit
  if (ran > 0) {
    const int* in = snd + ((ran - 1) & 1) * P * NL;
    if (delivers) deliver(ran - 1, in);
    else park(in);
  }
  if (delivers && live && sl == 0) del_ovf[r] = ovf;
  tick_barrier(2 * group, false);
  if (delivers) {
    if (is_fifo) a.out_cnt[r * NP + sl] = out_cnt;
    if (live && sl == 0) a.t_done[r] = tdone;
  } else {
    if (live && sl == 0) a.overflow[r] = ovf + del_ovf[r];
    if (tid == 0) a.ticks[0] = ran;
  }
}

// out_pay[q, slot] = inq_pay[org[q, slot]] for slot < out_cnt[q], zeros
// beyond, over the (P * NP) output queues of OC slots; W words of 16 bytes
// (vec4) or of 4 bytes a packet
template <typename V>
__global__ void router_gather_kernel(const V* __restrict__ inq_pay, const int* __restrict__ org,
                                     const int* __restrict__ out_cnt, V* __restrict__ out_pay,
                                     int64_t rows, int OC, int W) {
  const int64_t total = rows * W;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = i / W;
    V v{};
    if (row % OC < out_cnt[row / OC]) v = inq_pay[static_cast<int64_t>(org[row]) * W + i % W];
    out_pay[i] = v;
  }
}

// kernels/router/kernel.py:warp_shared_bytes computes the same for the dispatch
size_t warp_shared_bytes(int P, int NP, int FC, int TC, int NL) {
  const int64_t origins = static_cast<int64_t>(P) * NP * FC;
  const size_t ring = origins <= (1 << 16) ? sizeof(uint16_t) : sizeof(uint32_t);
  return (2 * static_cast<size_t>(P) * NL + static_cast<size_t>(P) * P + P) * sizeof(int) +
         static_cast<size_t>(P) * TC * ring + static_cast<size_t>(origins);
}

template <typename RingT>
int launch_warp(const WarpArgs& a, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(router_warp_kernel<RingT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  router_warp_kernel<RingT><<<1, kWarpBlock, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Two launches: the control kernel (one block of 1024 threads, of which the
// first 2 * ceil(P / (32 / L)) warps tick) and the payload gather.  out_pay needs no zeroing: the gather writes every slot.
// Returns the CUDA error of the launches (0 on success);
// cudaErrorInvalidValue for a shape the path does not take: P > 32,
// NP + 1 > 32, NL > 32, more than 16 warps of ranks, P * NP * FC >= 2^20
// origins, or more shared memory than a block can have.
extern "C" int smi_router_run_warp(const void* inq_pay, const void* inq_dst, const void* inq_len,
                                   const void* route_tbl, const void* src_tbl,
                                   const void* link_ids, void* out_pay, void* out_cnt,
                                   void* overflow, void* t_done, void* ticks, void* org, int P,
                                   int NP, int FC, int TC, int OC, int E, int NL, int R,
                                   int bubble, int n_steps, void* stream) {
  if (P < 1 || P > 32 || NP < 1 || NP + 1 > 32 || NL < 1 || NL > 32 || FC < 1 || TC < 1 ||
      OC < 1 || E < 1 || static_cast<int64_t>(P) * NP * FC >= (int64_t{1} << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = warp_shared_bytes(P, NP, FC, TC, NL);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WarpArgs a{static_cast<const int*>(inq_dst), static_cast<const int*>(inq_len),
             static_cast<const int*>(route_tbl), static_cast<const int*>(src_tbl),
             static_cast<const int*>(link_ids), static_cast<int*>(org),
             static_cast<int*>(out_cnt), static_cast<int*>(overflow),
             static_cast<int*>(t_done), static_cast<int*>(ticks),
             P, NP, FC, TC, OC, NL, R, bubble, n_steps, 1};
  while (a.L < NL || a.L < NP + 1) a.L *= 2;
  if (2 * 32 * ((P + 32 / a.L - 1) / (32 / a.L)) > kWarpBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = static_cast<int64_t>(P) * NP * FC <= (1 << 16)
                      ? launch_warp<uint16_t>(a, smem, s)
                      : launch_warp<uint32_t>(a, smem, s);
  if (err != 0) return err;
  const int64_t rows = static_cast<int64_t>(P) * NP * OC;
  const uintptr_t align = reinterpret_cast<uintptr_t>(inq_pay) |
                          reinterpret_cast<uintptr_t>(out_pay);
  const bool vec4 = E % 4 == 0 && align % 16 == 0;
  const int W = vec4 ? E / 4 : E;
  const int blocks = static_cast<int>(std::min<int64_t>((rows * W + 255) / 256, 132 * 8));
  if (vec4)
    router_gather_kernel<uint4><<<blocks, 256, 0, s>>>(
        static_cast<const uint4*>(inq_pay), static_cast<const int*>(org),
        static_cast<const int*>(out_cnt), static_cast<uint4*>(out_pay), rows, OC, W);
  else
    router_gather_kernel<uint32_t><<<blocks, 256, 0, s>>>(
        static_cast<const uint32_t*>(inq_pay), static_cast<const int*>(org),
        static_cast<const int*>(out_cnt), static_cast<uint32_t*>(out_pay), rows, OC, W);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The block-tick form (smi_router_tick_block): ONE tick of a block of ranks.
//
// Ranks run as processes (core/spmd.py), each process holding the ranks
// [lo, lo + n); a tick's link packets cross between processes through mapped
// mailboxes, so a process cannot run a whole router run in one launch.  This
// form is the reference Pallas kernel's own unit of work, one tick per call:
// absorb the arrivals of tick t - 1 (labelled t - 1), then arbitrate, pop
// and write the send rows of tick t and each rank's pending count, exactly
// as kernels/router/ref.py:router_tick computes it.  The router state lives
// in device tensors the wrapper owns (kernels/router/kernel.py:
// router_tick_block), read and written in place, so it persists across
// launches.  A link row is 3 + E int32 words: destination, port, valid, then
// the payload's bits; the payload travels in the row, since a peer process
// has no mapping of the staged input a packet came from.
//
// One block a rank; its thread 0 walks the arrivals in link order (the
// reference's exclusive prefix sums) and arbitrates (one masked rotated
// argmax a link, transit first, R-stickiness, the switch bubble), recording
// which payload rows move where; then the block copies the absorbed
// payloads, and after a barrier the sent ones (a packet parked this tick may
// leave this tick, from the slot the first copies wrote).  An invalid send
// carries the payload of FIFO 0's head, as the plain version's gather does.
//
// Bound on an H100: a launch, not bytes: a tick moves at most n * NL rows.
// ---------------------------------------------------------------------------

namespace {

constexpr int kRowHead = 3;        // destination, port, valid ahead of the payload
constexpr int kTickLinks = 32;     // most links a rank takes
constexpr int kTickThreads = 128;

struct TickArgs {
  const uint32_t* inq_pay;  // (n, NP, FC, E) staged payload words
  const int* inq_dst;       // (n, NP, FC)
  const int* inq_len;       // (n, NP)
  const int* tbl;           // (n, P) the block's rows of the route table
  const int* link_ids;      // (NL,)
  const int* arr;           // (n, NL, 3 + E) the arrivals of tick t - 1
  int* snd;                 // (n, NL, 3 + E) the send rows of tick t
  int* inq_head;            // (n, NP)
  uint32_t* tr_pay;         // (n, TC, E)
  int *tr_dst, *tr_port;    // (n, TC)
  int *tr_head, *tr_cnt;    // (n,)
  uint32_t* out_pay;        // (n, NP, OC, E)
  int* out_cnt;             // (n, NP)
  int* overflow;            // (n,)
  int *last_src, *stick;    // (n, NL)
  int* t_done;              // (n,)
  int* pending;             // (n,) staged + parked + sent after the tick
  int lo, P, NP, FC, TC, OC, E, NL, R, bubble, t, arbitrate;
};

__device__ void block_absorb(const TickArgs& a, int b, const uint32_t** cp_src,
                             uint32_t** cp_dst) {
  const int rank = a.lo + b, W = kRowHead + a.E;
  for (int li = 0; li < a.NL; ++li) {
    cp_src[li] = nullptr;
    const int* row = a.arr + (static_cast<int64_t>(b) * a.NL + li) * W;
    if (!row[2]) continue;
    const int dst = row[0], prt = row[1];
    const uint32_t* pay = reinterpret_cast<const uint32_t*>(row + kRowHead);
    if (dst == rank) {
      const int p = min(max(prt, 0), a.NP - 1);
      const int slot = a.out_cnt[b * a.NP + p];
      if (slot < a.OC) {
        cp_src[li] = pay;
        cp_dst[li] = a.out_pay + ((static_cast<int64_t>(b) * a.NP + p) * a.OC + slot) * a.E;
        a.out_cnt[b * a.NP + p] = slot + 1;
        a.t_done[b] = a.t - 1;
      } else {
        a.overflow[b] += 1;
      }
    } else if (a.tr_cnt[b] < a.TC) {
      const int pos = (a.tr_head[b] + a.tr_cnt[b]) % a.TC;
      cp_src[li] = pay;
      cp_dst[li] = a.tr_pay + (static_cast<int64_t>(b) * a.TC + pos) * a.E;
      a.tr_dst[b * a.TC + pos] = dst;
      a.tr_port[b * a.TC + pos] = prt;
      a.tr_cnt[b] += 1;
    } else {
      a.overflow[b] += 1;
    }
  }
}

__device__ void block_arbitrate(const TickArgs& a, int b, const uint32_t** cp_src,
                                uint32_t** cp_dst) {
  const int rank = a.lo + b, S = a.NP + 1, W = kRowHead + a.E;
  int cdst[kMaxSrcs], cprt[kMaxSrcs], cwant[kMaxSrcs];
  const uint32_t* cpay[kMaxSrcs];
  unsigned has = 0;
  for (int p = 0; p < a.NP; ++p) {
    const int h = a.inq_head[b * a.NP + p];
    const int64_t row = (static_cast<int64_t>(b) * a.NP + p) * a.FC + min(h, a.FC - 1);
    if (h < a.inq_len[b * a.NP + p]) has |= 1u << p;
    cdst[p] = a.inq_dst[row];
    cprt[p] = p;
    cpay[p] = a.inq_pay + row * a.E;
  }
  const int th = a.tr_head[b] % a.TC;
  if (a.tr_cnt[b] > 0) has |= 1u << (S - 1);
  cdst[S - 1] = a.tr_dst[b * a.TC + th];
  cprt[S - 1] = a.tr_port[b * a.TC + th];
  cpay[S - 1] = a.tr_pay + (static_cast<int64_t>(b) * a.TC + th) * a.E;
  for (int c = 0; c < S; ++c)
    cwant[c] = cdst[c] == rank ? -2 : a.tbl[static_cast<int64_t>(b) * a.P +
                                            min(max(cdst[c], 0), a.P - 1)];

  int sent = 0;
  for (int li = 0; li < a.NL; ++li) {
    const int k = b * a.NL + li, lid = a.link_ids[li];
    unsigned avail = 0;
    for (int c = 0; c < S; ++c)
      if (((has >> c) & 1u) && cwant[c] == lid) avail |= 1u << c;
    const int last = a.last_src[k];
    const bool tr_want = (avail >> (S - 1)) & 1u;
    const bool keep = a.stick[k] < a.R && ((avail >> min(max(last, 0), S - 1)) & 1u);
    int rr = (last + 1) % S;  // argmax of an all-false row picks its first entry
    for (int j = 0; j < S; ++j) {
      const int c = (last + 1 + j) % S;
      if ((avail >> c) & 1u) { rr = c; break; }
    }
    const int chosen = tr_want ? S - 1 : (keep ? last : rr);
    const bool any = avail != 0;
    const bool send = a.bubble ? (any && chosen == last) : any;
    a.last_src[k] = any ? chosen : last;
    a.stick[k] = (send && chosen == last) ? a.stick[k] + 1 : 0;
    int* row = a.snd + static_cast<int64_t>(k) * W;
    row[2] = send;
    cp_dst[li] = reinterpret_cast<uint32_t*>(row + kRowHead);
    if (send) {
      if (chosen < a.NP) {
        a.inq_head[b * a.NP + chosen] += 1;
      } else {
        a.tr_head[b] += 1;
        a.tr_cnt[b] -= 1;
      }
      row[0] = cdst[chosen];
      row[1] = cprt[chosen];
      cp_src[li] = cpay[chosen];
      ++sent;
    } else {
      row[0] = -1;
      row[1] = 0;
      cp_src[li] = cpay[0];
    }
  }
  int pending = a.tr_cnt[b] + sent;
  for (int p = 0; p < a.NP; ++p) pending += a.inq_len[b * a.NP + p] - a.inq_head[b * a.NP + p];
  a.pending[b] = pending;
}

// the block's threads copy n rows of E words, row c from src[c] to dst[c]
// (a null source: nothing to copy)
__device__ void copy_rows(const uint32_t* const* src, uint32_t* const* dst, int n, int E) {
  for (int i = threadIdx.x; i < n * E; i += blockDim.x) {
    const int c = i / E;
    if (src[c]) dst[c][i - c * E] = src[c][i - c * E];
  }
}

__global__ void router_tick_block_kernel(TickArgs a) {
  __shared__ const uint32_t* abs_src[kTickLinks];
  __shared__ uint32_t* abs_dst[kTickLinks];
  __shared__ const uint32_t* snd_src[kTickLinks];
  __shared__ uint32_t* snd_dst[kTickLinks];
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    block_absorb(a, b, abs_src, abs_dst);
    if (a.arbitrate) block_arbitrate(a, b, snd_src, snd_dst);
  }
  __syncthreads();
  copy_rows(abs_src, abs_dst, a.NL, a.E);
  if (!a.arbitrate) return;
  __syncthreads();  // a packet parked this tick may be sent from its new slot
  copy_rows(snd_src, snd_dst, a.NL, a.E);
}

}  // namespace

// One launch: one tick of the ranks [lo, lo + n) of P, a block each.  With
// arbitrate == 0 it only absorbs (the arrivals still in flight when a run
// ends).  Returns the CUDA error of the launch (0 on success);
// cudaErrorInvalidValue for a shape it does not take: NP + 1 > 16 or NL > 32.
extern "C" int smi_router_tick_block(
    const void* inq_pay, const void* inq_dst, const void* inq_len, const void* tbl,
    const void* link_ids, const void* arr, void* snd, void* inq_head, void* tr_pay,
    void* tr_dst, void* tr_port, void* tr_head, void* tr_cnt, void* out_pay, void* out_cnt,
    void* overflow, void* last_src, void* stick, void* t_done, void* pending, int n, int lo,
    int P, int NP, int FC, int TC, int OC, int E, int NL, int R, int bubble, int t,
    int arbitrate, void* stream) {
  if (n < 1 || lo < 0 || lo + n > P || NP < 1 || NP + 1 > kMaxSrcs || NL < 1 ||
      NL > kTickLinks || FC < 1 || TC < 1 || OC < 1 || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  TickArgs a{static_cast<const uint32_t*>(inq_pay), static_cast<const int*>(inq_dst),
             static_cast<const int*>(inq_len), static_cast<const int*>(tbl),
             static_cast<const int*>(link_ids), static_cast<const int*>(arr),
             static_cast<int*>(snd), static_cast<int*>(inq_head),
             static_cast<uint32_t*>(tr_pay), static_cast<int*>(tr_dst),
             static_cast<int*>(tr_port), static_cast<int*>(tr_head), static_cast<int*>(tr_cnt),
             static_cast<uint32_t*>(out_pay), static_cast<int*>(out_cnt),
             static_cast<int*>(overflow), static_cast<int*>(last_src), static_cast<int*>(stick),
             static_cast<int*>(t_done), static_cast<int*>(pending),
             lo, P, NP, FC, TC, OC, E, NL, R, bubble, t, arbitrate};
  router_tick_block_kernel<<<n, kTickThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
