// Causal GQA flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `flash_attention_fwd` (body `_fwd_kernel`) of
// src/repro/kernels/flash_attention.py and computes what it computes:
//   s = (q . k) * D^-0.5, then softcap * tanh(s / softcap) when softcap > 0;
//   causal mask (key position > query position -> -1e30); with a window
//   W > 0 also keys at W or more positions before the query (query t attends
//   [t-W+1, t], as ref.attention_ref(window=W); the TPU kernel has no window);
//   online softmax with running max m, sum l and accumulator in f32;
//   P.V in f32 (the TPU kernel casts v to f32 before the product);
//   o = acc / max(l, 1e-30), stored in q's dtype.
// GQA: query head h reads kv head h / (Hq / Hk).
//
// Design. One block of 256 threads per (query tile of 64 rows, query head,
// batch row). The block keeps its query tile in shared memory and walks the
// key/value tiles from 0 up to the diagonal in a loop, staging each 64-row
// tile in shared memory as f32; there is no sequential grid axis and nothing
// crosses blocks. Thread (ty, tx) of the 16 x 16 grid owns query rows
// ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and output columns
// tx + 16 c (c < D / 16), so the row max and row sum of the online softmax
// are reduced with four shuffles inside a half warp and the rescale factor
// stays in registers. The kernel reads the public [B, S, H, D] layout
// through its strides (no transposed copies), masks the ragged tail itself
// (any S works; rows past S are zero-filled and never stored), and heavier
// query tiles (more key tiles under the diagonal) are launched first. With
// a window the key-tile loop starts at the tile holding the band's first key
// of the query tile's first row, and the band is masked inside the tiles
// that straddle its edges; a masked score's probability is 0, so a row that
// has no key in the band within a tile adds nothing to l or acc. The window
// adds no shared memory, and it is a separate instantiation: without one
// (window 0) the kernel is the causal kernel as it was, with no extra work.
// Rows of Q and K in shared memory are padded to D + 1 floats, so the
// column walks of the score product touch 16 distinct banks.
//
// What bounds it. At the serving shape (B=4, S=512, H=16, D=64, bf16) the
// function moves 16.8 MB and does 2.2 GFLOP, so the card's bound is bytes
// (about 5 us at 3.35 TB/s); at S=4096 it is operations, and so it is at
// recurrentgemma-2b's windowed shape (B=4, S=4096, Hq=10, Hk=1, D=256,
// W=2048: 2.58e11 FLOP over the band, 184.5 MB; 0.261 ms). This kernel does
// its arithmetic as scalar f32 FMAs on the CUDA cores (67 TFLOP/s, not the
// 989 of the bf16 tensor cores) and its inner loops issue one shared-memory
// load per two FMAs, so it sits far above that bound. That is the price of
// a first kernel that is right in f32 as the TPU kernel is; moving QK^T to
// mma/wgmma, and loading tiles with cp.async/TMA, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAX_DEVICES = 64;
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per shared-memory tile
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int RN = BQ / 16;   // query rows per thread
constexpr int CN = BK / 16;   // score columns per thread
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int s, hq, hk;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  float scale, softcap;
  int window;  // 0: none
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) +
                          size_t(BK) * D + size_t(BQ) * (BK + 1));
}

template <typename T, int D, bool WINDOWED>
__global__ void __launch_bounds__(THREADS) fa_fwd_kernel(const Args a) {
  constexpr int LD = D + 1;   // padded row of qs / ks
  constexpr int LDP = BK + 1;  // padded row of ps
  constexpr int DN = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // [BQ][LD]
  float* ks = qs + BQ * LD;    // [BK][LD]
  float* vs = ks + BK * LD;    // [BK][D]
  float* ps = vs + BK * D;     // [BQ][LDP] probabilities of the current tile

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = h / (a.hq / a.hk);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = qt * BQ;

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + hkv * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + hkv * a.v_sh;
  T* og = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D, s = q0 + r;
    qs[r * LD + c] = s < a.s ? to_f32(qg[s * a.q_ss + c]) : 0.f;
  }

  float m[RN], l[RN], acc[RN][DN];
#pragma unroll
  for (int i = 0; i < RN; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;
  }

  // key tiles from the one holding the band's first key of row q0 (0 without
  // a window) to the one holding the tile's last valid query row
  const int kt0 = WINDOWED ? max(0, q0 - a.window + 1) / BK : 0;
  const int n_kv = (min(q0 + BQ, a.s) - 1) / BK + 1;
  for (int kt = kt0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's ks / vs / ps are consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D, s = k0 + r;
      const bool in = s < a.s;
      ks[r * LD + c] = in ? to_f32(kg[s * a.k_ss + c]) : 0.f;
      vs[r * D + c] = in ? to_f32(vg[s * a.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float sc[RN][CN];
#pragma unroll
    for (int i = 0; i < RN; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RN], kv[CN];
#pragma unroll
      for (int i = 0; i < RN; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RN; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        float x = sc[i][j] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        const int kpos = k0 + tx + 16 * j;
        if (kpos > qpos || (WINDOWED && qpos - kpos >= a.window)) x = NEG_INF;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads of a row group are one half warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = (WINDOWED && sc[i][j] == NEG_INF) ? 0.f : expf(sc[i][j] - m_new);
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DN; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RN], vv[DN];
#pragma unroll
      for (int i = 0; i < RN; ++i) pv[i] = ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < DN; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int c = 0; c < DN; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RN; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s < a.s) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < DN; ++c) store(og + s * a.o_ss + tx + 16 * c, acc[i][c] / denom);
    }
  }
}

template <typename T, int D, bool WINDOWED>
cudaError_t launch(const Args& a, int batch, int device, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // The shared-memory limit is raised once per device for each instantiation,
  // not on every launch (prefill is host-bound: each runtime call counts).
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!smem_set[device].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_fwd_kernel<T, D, WINDOWED>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    smem_set[device].store(true, std::memory_order_release);
  }
  const dim3 grid((a.s + BQ - 1) / BQ, a.hq, batch);
  fa_fwd_kernel<T, D, WINDOWED><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool WINDOWED>
cudaError_t launch_d(const Args& a, int batch, int d, int device, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16, WINDOWED>(a, batch, device, stream);
    case 32: return launch<T, 32, WINDOWED>(a, batch, device, stream);
    case 64: return launch<T, 64, WINDOWED>(a, batch, device, stream);
    case 128: return launch<T, 128, WINDOWED>(a, batch, device, stream);
    case 256: return launch<T, 256, WINDOWED>(a, batch, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_w(const Args& a, int batch, int d, int device, cudaStream_t stream) {
  return a.window > 0 ? launch_d<T, true>(a, batch, d, device, stream)
                      : launch_d<T, false>(a, batch, d, device, stream);
}

}  // namespace

extern "C" {

// device: the caller's current CUDA device (the one the tensors and the
// stream belong to); this function does not change the current device.
// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last dim
// of q, k, v and o is contiguous. window: 0 for none, else W > 0 (query t
// attends keys [t-W+1, t]). Returns the CUDA error code of the launch.
int repro_flash_attention_fwd(int device, void* stream, int dtype,
                              const void* q, const void* k, const void* v, void* o,
                              int batch, int s, int hq, int hk, int d,
                              int64_t q_sb, int64_t q_ss, int64_t q_sh,
                              int64_t k_sb, int64_t k_ss, int64_t k_sh,
                              int64_t v_sb, int64_t v_ss, int64_t v_sh,
                              int64_t o_sb, int64_t o_ss, int64_t o_sh,
                              float scale, float softcap, int window) {
  const Args a{q, k, v, o, s, hq, hk,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
               v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
               scale, softcap, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_w<float>(a, batch, d, device, st));
    case 1: return int(launch_w<__nv_bfloat16>(a, batch, d, device, st));
    default: return int(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
