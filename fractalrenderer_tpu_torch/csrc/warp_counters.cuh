// Per-warp counters of the escape kernels K1 (csrc/escape.cu) and K2
// (csrc/dd_escape.cu), kTripFields int32 per warp in an optional trips
// buffer (ops/escape.py TRIP_FIELDS; ops/escape.py decode_trips reads it):
//
//   trips       loop trips the warp ran
//   lane_iters  the sum over those trips of the lanes that applied an
//               update (every pixel's loop updates, once each)
//   pixels      pixels the warp finished
//   looped      of those, the pixels that entered the loop (the rest were
//               skipped as provably interior)
//   smid        the SM the warp ran on
//   loop_clk    SM clock cycles in the mapping, skip test and loop
//   epi_clk     SM clock cycles after the loop, to the pixels' last store
//   start, loop, end   %globaltimer (ns) at the warp's start, at the end
//               of its loop and at its end, each a (lo, hi) pair:
//               clock() counts per SM and the SMs' counters are not
//               aligned, the global timer is
//
// Lane 0 of the warp writes the row; a warp with no pixel leaves it zero.

#ifndef FR_WARP_COUNTERS_CUH_
#define FR_WARP_COUNTERS_CUH_

enum { T_TRIPS, T_LANE_ITERS, T_PIXELS, T_LOOPED, T_SMID, T_LOOP_CLK,
       T_EPI_CLK, T_START_LO, T_START_HI, T_LOOP_LO, T_LOOP_HI, T_END_LO,
       T_END_HI };
constexpr int kTripFields = 13;

struct WarpStamp {
  unsigned long long ns;
  unsigned clk;
};

static __device__ __forceinline__ WarpStamp warp_stamp() {
  WarpStamp s;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(s.ns));
  s.clk = static_cast<unsigned>(clock());
  return s;
}

static __device__ __forceinline__ int warp_sm_id() {
  int s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}

// Lane 0 writes the warp's row: the counts (already summed over the warp)
// and the three stamps' times.
static __device__ __forceinline__ void write_trips(
    int* wt, unsigned trips, unsigned lane_iters, unsigned pixels,
    unsigned looped, unsigned loop_clk, unsigned epi_clk, WarpStamp start,
    WarpStamp loop, WarpStamp end) {
  wt[T_TRIPS] = static_cast<int>(trips);
  wt[T_LANE_ITERS] = static_cast<int>(lane_iters);
  wt[T_PIXELS] = static_cast<int>(pixels);
  wt[T_LOOPED] = static_cast<int>(looped);
  wt[T_SMID] = warp_sm_id();
  wt[T_LOOP_CLK] = static_cast<int>(loop_clk);
  wt[T_EPI_CLK] = static_cast<int>(epi_clk);
  wt[T_START_LO] = static_cast<int>(start.ns);
  wt[T_START_HI] = static_cast<int>(start.ns >> 32);
  wt[T_LOOP_LO] = static_cast<int>(loop.ns);
  wt[T_LOOP_HI] = static_cast<int>(loop.ns >> 32);
  wt[T_END_LO] = static_cast<int>(end.ns);
  wt[T_END_HI] = static_cast<int>(end.ns >> 32);
}

// One thread per pixel in 32-wide rows of a (32, 8) block: the lanes of
// this warp that hold a pixel (the rest fall off the right edge), and the
// warp's row of the trips buffer.
static __device__ __forceinline__ unsigned row_lanes(int width) {
  const int left = width - static_cast<int>(blockIdx.x) * 32;
  return left >= 32 ? 0xffffffffu : (1u << left) - 1u;
}
static __device__ __forceinline__ int* warp_row(int* trips) {
  return trips + kTripFields * static_cast<int>(
      ((blockIdx.y * gridDim.x + blockIdx.x) << 3) + threadIdx.y);
}

// The counters of a warp of such a grid: every lane passes its pixel's
// loop updates and whether it entered the loop; the loop ran as long as
// its longest lane.
static __device__ __forceinline__ void finish_row_trips(
    int* wt, unsigned mask, int iters, bool looped, WarpStamp start,
    WarpStamp loop) {
  __syncwarp(mask);
  const unsigned it = static_cast<unsigned>(iters);
  const unsigned trips = __reduce_max_sync(mask, it);
  const unsigned lane_iters = __reduce_add_sync(mask, it);
  const unsigned n_looped = __popc(__ballot_sync(mask, looped));
  if (threadIdx.x == 0) {
    const WarpStamp end = warp_stamp();
    write_trips(wt, trips, lane_iters, __popc(mask), n_looped,
                loop.clk - start.clk, end.clk - loop.clk, start, loop, end);
  }
}

#endif  // FR_WARP_COUNTERS_CUH_
