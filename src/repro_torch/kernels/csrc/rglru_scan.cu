// RG-LRU diagonal linear recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `rglru_scan_pallas` (body `_rglru_kernel`) of
// src/repro/kernels/rglru_scan.py and computes what it computes:
//   h_t = a_t * h_{t-1} + b_t   per (batch row, channel), from h_{-1} = 0,
// in f32 (a and b are read in their dtype and widened), every h_t stored in
// f32 into a contiguous [B, S, W] output. The product and the sum are rounded
// one after the other (no fused multiply-add), as the plain version
// `ref.rglru_ref` computes them, so the two agree bit for bit on the card.
//
// Design. Channels are independent, so one thread owns one (batch row,
// channel) and walks the whole sequence with h in a register: the TPU
// kernel's sequential sequence axis, with its state in VMEM scratch carried
// across sequence blocks, becomes this loop, and nothing crosses threads.
// The 32 threads of a warp own 32 consecutive channels, so each step's loads
// of a_t, b_t and store of h_t are coalesced. The loads do not depend on h:
// they are issued U steps ahead (the next U steps are loaded into registers
// while the current U are computed), so the loop does not wait one DRAM
// latency per step. Blocks of 64 threads give B * W / 64 blocks (160 at the
// serving shape B = 4, W = 2560, on 132 SMs). Inputs are read through their
// strides; any S and any W work (steps past S and channels past W are
// masked, where the Pallas wrapper needs block sizes that divide S and W).
//
// What bounds it. At the serving shape [4, 4096, 2560] in f32 the function
// moves 3 x 167.8 MB (a and b read once, h written once) and does 2 flops an
// element, so the card's bound is bytes: 0.150 ms at 3.35 TB/s. With one
// thread a channel only 10,240 threads run (about 2.4 warps an SM), so the
// bytes in flight, U steps of a and b a thread, set the rate this kernel
// reaches. A two-pass scan that also splits S across blocks would fill the
// card; that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;  // channels per block
constexpr int U = 16;        // steps loaded ahead of the recurrence

struct Args {
  const void* a;
  const void* b;
  float* h;
  int s, w;
  int64_t a_sb, a_ss, a_sw;
  int64_t b_sb, b_ss, b_sw;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ void load(const T* a, const T* b, int64_t a_ss, int64_t b_ss,
                                     int t0, int s, float (&av)[U], float (&bv)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    av[u] = t < s ? to_f32(a[t * a_ss]) : 0.f;
    bv[u] = t < s ? to_f32(b[t * b_ss]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rglru_kernel(const Args g) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int row = blockIdx.y;
  if (c >= g.w) return;
  const T* a = static_cast<const T*>(g.a) + row * g.a_sb + c * g.a_sw;
  const T* b = static_cast<const T*>(g.b) + row * g.b_sb + c * g.b_sw;
  float* h_out = g.h + (int64_t(row) * g.s) * g.w + c;

  float ca[U], cb[U], na[U], nb[U];
  load(a, b, g.a_ss, g.b_ss, 0, g.s, ca, cb);
  float h = 0.f;
  for (int t0 = 0; t0 < g.s; t0 += U) {
    load(a, b, g.a_ss, g.b_ss, t0 + U, g.s, na, nb);  // the next U steps, in flight
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < g.s) {
        h = __fadd_rn(__fmul_rn(ca[u], h), cb[u]);
        h_out[int64_t(t) * g.w] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
}

template <typename T>
cudaError_t launch(const Args& g, int batch, cudaStream_t stream) {
  const dim3 grid((g.w + THREADS - 1) / THREADS, batch);
  rglru_kernel<T><<<grid, THREADS, 0, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of a and b: 0 = float32, 1 = bfloat16. Strides are in elements; h is
// a contiguous [batch, s, w] float32 output. Launches on `stream`, on the
// caller's current device. Returns the CUDA error code of the launch.
int repro_rglru_scan_fwd(void* stream, int dtype, const void* a, const void* b, float* h,
                         int batch, int s, int w,
                         int64_t a_sb, int64_t a_ss, int64_t a_sw,
                         int64_t b_sb, int64_t b_ss, int64_t b_sw) {
  const Args g{a, b, h, s, w, a_sb, a_ss, a_sw, b_sb, b_ss, b_sw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch<float>(g, batch, st));
    case 1: return int(launch<__nv_bfloat16>(g, batch, st));
    default: return int(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
