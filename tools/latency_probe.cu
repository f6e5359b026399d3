// Dependent-issue latency, in SM clock cycles, of the instructions a
// one-lane chain is made of (tools/sass_chain_model.py reads them).  One
// thread runs a chain of N dependent links between two clock64 reads, for
// N = 256 and N = 512; the difference over 256 is the cycles of one link,
// the reads' own cost cancelling.  The first links are inline PTX that
// ptxas lowers to one SASS instruction (two for the pairs; the rcp and
// xor links add an FADD or IADD3 so that ptxas cannot fold two links into
// none).  The last are C loops: IEEE sqrtf and division, whose fast paths
// take a branch over the slow path's CALL, a branch over a division and
// one into it, the shapes of the kernels' own code; the model is held
// against them.
// Build with the kernels' flags (ops/_cuda.py NVCC_FLAGS):
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false \
//         -o probe latency_probe.cu
//     ./probe    # prints one JSON object {link: cycles}
#include <cstdio>

#define CHAIN(NAME, T, CONS, PTX)                                          \
  template <int N>                                                         \
  __global__ void NAME(T* io, long long* cyc) {                            \
    T x = io[0];                                                           \
    const T a = io[1], b = io[2];                                          \
    const long long t0 = clock64();                                        \
    _Pragma("unroll") for (int i = 0; i < N; ++i) {                        \
      asm volatile(PTX : "+" CONS(x) : CONS(a), CONS(b));                  \
    }                                                                      \
    const long long t1 = clock64();                                        \
    io[3] = x;                                                             \
    cyc[0] = t1 - t0;                                                      \
  }

CHAIN(ffma, float, "f", "fma.rn.f32 %0, %0, %1, %2;")
CHAIN(fmnmx, float, "f", "max.f32 %0, %0, %1;")
CHAIN(fsetp_fsel, float, "f",
      "{ .reg .pred p; setp.gt.f32 p, %0, %1; selp.f32 %0, %2, %0, p; }")
CHAIN(mufu_rsq, float, "f", "rsqrt.approx.ftz.f32 %0, %0;")
CHAIN(mufu_rcp_fadd, float, "f",
      "rcp.approx.ftz.f32 %0, %0; add.f32 %0, %0, %2;")
CHAIN(mufu_lg2, float, "f", "lg2.approx.ftz.f32 %0, %0;")
CHAIN(mufu_ex2, float, "f", "ex2.approx.ftz.f32 %0, %0;")
CHAIN(mufu_sqrt, float, "f", "sqrt.approx.ftz.f32 %0, %0;")
CHAIN(imad, int, "r", "mad.lo.s32 %0, %0, %1, %2;")
CHAIN(iadd3, int, "r", "add.s32 %0, %0, %1;")
CHAIN(lop3_iadd3, int, "r", "xor.b32 %0, %0, %1; add.s32 %0, %0, %2;")
CHAIN(isetp_sel, int, "r",
      "{ .reg .pred p; setp.lt.s32 p, %0, %1; selp.b32 %0, %2, %0, p; }")
CHAIN(f2i_i2f, float, "f",
      "{ .reg .s32 i; cvt.rzi.s32.f32 i, %0; cvt.rn.f32.s32 %0, i; }")

// A loop of N / 4 trips of 4 links each (the loop small enough to stay in
// the instruction cache, which 512 unrolled links of IEEE code are not);
// a link's cycles then hold a quarter of the loop's own trip.
#define LOOP_C(NAME, BODY)                                                 \
  template <int N>                                                         \
  __global__ void NAME(float* io, long long* cyc) {                        \
    float x = io[0];                                                       \
    const float a = io[1], b = io[2];                                      \
    const int trips = N / 4 * static_cast<int>(io[4]);                     \
    const long long t0 = clock64();                                        \
    _Pragma("unroll 1") for (int i = 0; i < trips; ++i) {                  \
      _Pragma("unroll") for (int j = 0; j < 4; ++j) { BODY; }              \
    }                                                                      \
    const long long t1 = clock64();                                        \
    io[3] = x;                                                             \
    cyc[0] = t1 - t0;                                                      \
  }

LOOP_C(sqrt_rn, x = sqrtf(x))
LOOP_C(div_rn, x = a / x)
// the common path jumps over the division / runs it (x stays near 1)
LOOP_C(skip, if (x > 1e30f) { x = b / x; } x = x * a)
LOOP_C(guard, if (x < 1e30f) { x = b / x; } x = x * a)

// one FFMA a trip: the loop's own trip
template <int N>
__global__ void loop_trip(float* io, long long* cyc) {
  float x = io[0];
  const float a = io[1], b = io[2];
  const int n = N * static_cast<int>(io[4]);
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(x) : "f"(a), "f"(b));
  }
  const long long t1 = clock64();
  io[3] = x;
  cyc[0] = t1 - t0;
}

// cycles of one link: (N = 512) - (N = 256), over 256, best of 5
template <typename T>
double link(void (*k256)(T*, long long*), void (*k512)(T*, long long*),
            T x, T a, T b) {
  T host[5] = {x, a, b, 0, 1};
  T* io;
  long long* cyc;
  cudaMalloc(&io, sizeof host);
  cudaMalloc(&cyc, sizeof(long long));
  cudaMemcpy(io, host, sizeof host, cudaMemcpyHostToDevice);
  double best = 1e30;
  for (int rep = 0; rep < 5; ++rep) {
    long long c[2];
    k256<<<1, 1>>>(io, cyc);
    cudaMemcpy(&c[0], cyc, sizeof(long long), cudaMemcpyDeviceToHost);
    k512<<<1, 1>>>(io, cyc);
    cudaMemcpy(&c[1], cyc, sizeof(long long), cudaMemcpyDeviceToHost);
    const double d = (c[1] - c[0]) / 256.0;
    if (rep > 0 && d < best) best = d;  // the first pair warms the caches
  }
  cudaFree(io);
  cudaFree(cyc);
  return best;
}

#define RUN(NAME, X, A, B)                                                 \
  std::printf("%s\"%s\": %.3f", first ? "" : ", ", #NAME,                  \
              link(NAME<256>, NAME<512>, X, A, B));                        \
  first = false;

int main() {
  bool first = true;
  std::printf("{");
  RUN(ffma, 1.0f, 0.999f, 0.001f)
  RUN(fmnmx, 1.0f, 0.5f, 0.0f)
  RUN(fsetp_fsel, 1.0f, 0.5f, 2.0f)
  RUN(mufu_rsq, 2.0f, 0.0f, 0.0f)
  RUN(mufu_rcp_fadd, 2.0f, 0.0f, 0.001f)
  RUN(mufu_lg2, 2.0f, 0.0f, 0.0f)
  RUN(mufu_ex2, 0.5f, 0.0f, 0.0f)
  RUN(mufu_sqrt, 2.0f, 0.0f, 0.0f)
  RUN(imad, 3, 5, 7)
  RUN(iadd3, 3, 5, 7)
  RUN(lop3_iadd3, 3, 5, 7)
  RUN(isetp_sel, 3, 5, 7)
  RUN(f2i_i2f, 3.5f, 0.0f, 0.0f)
  RUN(sqrt_rn, 2.0f, 0.0f, 0.0f)
  RUN(div_rn, 2.0f, 1.5f, 0.0f)
  RUN(skip, 1.0f, 0.999f, 1.0f)
  RUN(guard, 1.0f, -1.0f, 1.0f)
  RUN(loop_trip, 1.0f, 0.999f, 0.001f)
  const cudaError_t err = cudaDeviceSynchronize();
  std::printf("}\n");
  if (err != cudaSuccess) {
    std::fprintf(stderr, "%s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
