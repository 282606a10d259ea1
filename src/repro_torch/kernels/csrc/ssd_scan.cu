// Mamba2 SSD chunked scan (forward) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `ssd_scan_chunked` (body `_ssd_kernel`) of
// src/repro/kernels/ssd_scan.py together with its wrapper `ops.ssd_scan`
// (src/repro/kernels/ops.py), and computes what they compute, all in f32:
// for each chunk of L steps, with xdt = x * dt, dA = dt * A, cs = cumsum(dA)
//   y_diag = (C B^T * Lmat) xdt       Lmat[i,j] = exp(cs_i - cs_j), i >= j
//   y_off  = exp(cs) * (C state)
//   state <- exp(cs_last) state + (B * exp(cs_last - cs))^T xdt
// y = y_diag + y_off is stored in x's dtype. Unlike the TPU kernel it also
// writes the final state [b, h, n, p] in f32, which the prefill cache needs.
//
// Design. One block of 256 threads per (batch * head, tile of PT columns of
// p): column q of y depends only on column q of xdt and of the state, so
// these blocks are independent (128 blocks at the serving shape b=4, h=32,
// p=64 with PT=64). The TPU kernel carries the state along a sequential
// chunk axis of its grid; here blocks run in no order, so each block walks
// the chunks itself and keeps its [n, PT] state in shared memory. Per chunk
// the block stages B^T, C (as f32) and its xdt columns in shared memory,
// then computes the L x L scores in row strips of 32 (only the columns under
// the diagonal), so the TPU's whole L x L decay matrix is never held at once:
// with L = n = 128 and PT = 64 the block uses 210 KB of the 227 KB a block
// may have. It reads x [b, s, h, p], dt [b, s, h] and B, C [b, s, g, n] in
// their public layout through strides, in their own dtypes (head hd reads
// group hd / (h / g)): no padded, repeated or transposed copies, unlike the
// TPU wrapper, which materialises B and C repeated over the heads in f32.
// The ragged tail is masked here: steps past s read dt = 0, B = C = x = 0,
// so they leave the state unchanged, and their y is never stored.
//
// What bounds it. At the serving shape (b=4, s=2048, h=32, p=64, n=128,
// L=128, bf16) the function moves 76.5 MB and does 21.5 GFLOP, so the card's
// bound is bytes, barely (about 23 us at 3.35 TB/s against 22 us at the bf16
// tensor peak). This kernel does its arithmetic as scalar f32 FMAs on the
// CUDA cores, recomputes C B^T for every head although the heads of a group
// share it, and runs one block of 8 warps per SM, so it sits far above that
// bound. That is the price of a first kernel that is right in f32, as the
// TPU kernel is; C B^T once per group and mma/wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAX_DEVICES = 64;
constexpr int THREADS = 256;
constexpr int LMAX = 128;  // longest chunk
constexpr int NMAX = 128;  // largest state
constexpr int RS = 32;     // rows of a score strip

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* state;
  int s, h, p, g, n, L;
  int64_t x_sb, x_ss, x_sh;
  int64_t dt_sb, dt_ss, dt_sh;
  int64_t b_sb, b_ss, b_sg;
  int64_t c_sb, c_ss, c_sg;
  int64_t y_sb, y_ss, y_sh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Floats of shared memory for a chunk of L steps, a state of n and PT columns.
__host__ __device__ constexpr size_t smem_floats(int L, int n, int pt) {
  return size_t(n) * (L + 1)      // bt: B^T of the chunk, rows padded
         + size_t(L) * (n + 1)    // cm: C of the chunk, rows padded
         + size_t(L) * pt         // xd: x * dt, this block's columns
         + size_t(n) * pt         // st: the carried state
         + size_t(RS) * (L + 1)   // ps: one strip of decayed, masked scores
         + size_t(L);             // cs: inclusive cumsum of dt * A
}

template <typename T, int PT>
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(const Args a) {
  constexpr int CN = PT / 16;  // output columns per thread
  constexpr int KN = NMAX / 16;  // state rows per thread, at most
  extern __shared__ float smem[];
  const int L = a.L, N = a.n;
  const int LB = L + 1, NB = N + 1;
  float* bt = smem;          // [N][LB]
  float* cm = bt + N * LB;   // [L][NB]
  float* xd = cm + L * NB;   // [L][PT]
  float* st = xd + L * PT;   // [N][PT]
  float* ps = st + N * PT;   // [RS][LB]
  float* cs = ps + RS * LB;  // [L]

  const int bh = blockIdx.x;
  const int b = bh / a.h, hd = bh % a.h;
  const int p0 = blockIdx.y * PT;
  const int grp = hd / (a.h / a.g);
  const int tid = threadIdx.x;

  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + hd * a.x_sh + p0;
  const float* dtg = a.dt + b * a.dt_sb + hd * a.dt_sh;
  const T* bg = static_cast<const T*>(a.B) + b * a.b_sb + grp * a.b_sg;
  const T* cg = static_cast<const T*>(a.C) + b * a.c_sb + grp * a.c_sg;
  T* yg = static_cast<T*>(a.y) + b * a.y_sb + hd * a.y_sh + p0;
  const float A = a.A[hd];

  for (int e = tid; e < N * PT; e += THREADS) st[e] = 0.f;

  const int n_chunks = (a.s + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < L * N; e += THREADS) {
      const int l = e / N, k = e % N, t = t0 + l;
      const bool in = t < a.s;
      bt[k * LB + l] = in ? to_f32(bg[t * a.b_ss + k]) : 0.f;
      cm[l * NB + k] = in ? to_f32(cg[t * a.c_ss + k]) : 0.f;
    }
    for (int e = tid; e < L * PT; e += THREADS) {
      const int l = e / PT, q = e % PT, t = t0 + l;
      xd[e] = t < a.s ? to_f32(xg[t * a.x_ss + q]) * dtg[t * a.dt_ss] : 0.f;
    }
    if (tid < 32) {  // cs = inclusive cumsum of dt * A: 4 steps a lane, then a warp scan
      const int per = (L + 31) / 32;
      float v[4], run = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = tid * per + i, t = t0 + l;
        if (i < per && l < L && t < a.s) run += dtg[t * a.dt_ss] * A;
        v[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float before = incl - run;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = tid * per + i;
        if (i < per && l < L) cs[l] = before + v[i];
      }
    }
    __syncthreads();

    for (int r0 = 0; r0 < L; r0 += RS) {
      const int kend = min(r0 + RS, L);  // the strip's rows see columns < kend
      {
        // scores of rows r0 + ty + 8i (i < 4), columns tx + 32j (j < 4)
        const int ty = tid >> 5, tx = tid & 31;
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        int rc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) rc[i] = min(r0 + ty + 8 * i, L - 1);
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cm[rc[i] * NB + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = 32 * j < kend ? bt[k * LB + tx + 32 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + ty + 8 * i;
          if (r >= L) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kk = tx + 32 * j;
            if (kk >= kend) continue;  // also keeps a short chunk's row in bounds
            ps[(ty + 8 * i) * LB + kk] = kk <= r ? sc[i][j] * expf(cs[r] - cs[kk]) : 0.f;
          }
        }
      }
      __syncthreads();
      {
        // y of rows r0 + ty + 16ii (ii < 2), columns tx + 16cc (cc < CN)
        const int ty = tid >> 4, tx = tid & 15;
        float acc[2][CN];
        int lc[2];
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          lc[ii] = min(r0 + ty + 16 * ii, L - 1);
#pragma unroll
          for (int cc = 0; cc < CN; ++cc) acc[ii][cc] = 0.f;
        }
#pragma unroll 4
        for (int k = 0; k < N; ++k) {  // C . state (the state entering the chunk)
          const float c0 = cm[lc[0] * NB + k], c1 = cm[lc[1] * NB + k];
#pragma unroll
          for (int cc = 0; cc < CN; ++cc) {
            const float sv = st[k * PT + tx + 16 * cc];
            acc[0][cc] = fmaf(c0, sv, acc[0][cc]);
            acc[1][cc] = fmaf(c1, sv, acc[1][cc]);
          }
        }
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const float e = expf(cs[lc[ii]]);
#pragma unroll
          for (int cc = 0; cc < CN; ++cc) acc[ii][cc] *= e;
        }
#pragma unroll 4
        for (int j = 0; j < kend; ++j) {  // + (C B^T * Lmat) xdt over the strip
          const float q0 = ps[ty * LB + j], q1 = ps[(ty + 16) * LB + j];
#pragma unroll
          for (int cc = 0; cc < CN; ++cc) {
            const float xv = xd[j * PT + tx + 16 * cc];
            acc[0][cc] = fmaf(q0, xv, acc[0][cc]);
            acc[1][cc] = fmaf(q1, xv, acc[1][cc]);
          }
        }
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int l = r0 + ty + 16 * ii, t = t0 + l;
          if (l < L && t < a.s) {
#pragma unroll
            for (int cc = 0; cc < CN; ++cc)
              store(yg + t * a.y_ss + tx + 16 * cc, acc[ii][cc]);
          }
        }
      }
      __syncthreads();  // ps is consumed before the next strip writes it
    }

    // state <- exp(cs_last) state + sum_l B[l]^T exp(cs_last - cs_l) xdt[l]
    const float last = cs[L - 1];
    for (int e = tid; e < L * PT; e += THREADS) xd[e] *= expf(last - cs[e / PT]);
    __syncthreads();
    {
      const int ty = tid >> 4, tx = tid & 15;
      const float decay = expf(last);
      float acc[KN][CN];
      int kc[KN];
#pragma unroll
      for (int i = 0; i < KN; ++i) {
        kc[i] = min(ty + 16 * i, N - 1);
#pragma unroll
        for (int cc = 0; cc < CN; ++cc) acc[i][cc] = decay * st[kc[i] * PT + tx + 16 * cc];
      }
#pragma unroll 2
      for (int l = 0; l < L; ++l) {
        float xv[CN];
#pragma unroll
        for (int cc = 0; cc < CN; ++cc) xv[cc] = xd[l * PT + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < KN; ++i) {
          if (16 * i >= N) continue;
          const float bv = bt[kc[i] * LB + l];
#pragma unroll
          for (int cc = 0; cc < CN; ++cc) acc[i][cc] = fmaf(bv, xv[cc], acc[i][cc]);
        }
      }
      __syncthreads();  // every thread has read st before it is overwritten
#pragma unroll
      for (int i = 0; i < KN; ++i) {
        if (ty + 16 * i < N) {
#pragma unroll
          for (int cc = 0; cc < CN; ++cc) st[(ty + 16 * i) * PT + tx + 16 * cc] = acc[i][cc];
        }
      }
    }
  }
  __syncthreads();
  float* sg = a.state + (size_t(bh) * N) * a.p + p0;
  for (int e = tid; e < N * PT; e += THREADS) sg[(e / PT) * a.p + e % PT] = st[e];
}

template <typename T, int PT>
cudaError_t launch(const Args& a, int batch, int device, cudaStream_t stream) {
  // The shared-memory limit is raised once per device for each instantiation.
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!smem_set[device].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(sizeof(float) * smem_floats(LMAX, NMAX, PT)));
    if (err != cudaSuccess) return err;
    smem_set[device].store(true, std::memory_order_release);
  }
  const size_t smem = sizeof(float) * smem_floats(a.L, a.n, PT);
  const dim3 grid(batch * a.h, a.p / PT);
  ssd_scan_kernel<T, PT><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pt(const Args& a, int batch, int device, cudaStream_t stream) {
  if (a.p % 64 == 0) return launch<T, 64>(a, batch, device, stream);
  if (a.p % 32 == 0) return launch<T, 32>(a, batch, device, stream);
  if (a.p % 16 == 0) return launch<T, 16>(a, batch, device, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// device: the caller's current CUDA device (the one the tensors and the
// stream belong to); this function does not change the current device.
// dtype of x, B, C and y: 0 = float32, 1 = bfloat16; dt and A are float32.
// Strides are in elements; the last dim of x, B, C and y is contiguous, and
// state is a contiguous [batch, h, n, p] float32 tensor. Needs 1 <= chunk <=
// 128, 1 <= n <= 128, p a multiple of 16, h a multiple of g. Returns the
// CUDA error code of the launch.
int repro_ssd_scan_fwd(int device, void* stream, int dtype,
                       const void* x, const void* dt, const void* A, const void* B,
                       const void* C, void* y, void* state,
                       int batch, int s, int h, int p, int g, int n, int chunk,
                       int64_t x_sb, int64_t x_ss, int64_t x_sh,
                       int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,
                       int64_t b_sb, int64_t b_ss, int64_t b_sg,
                       int64_t c_sb, int64_t c_ss, int64_t c_sg,
                       int64_t y_sb, int64_t y_ss, int64_t y_sh) {
  if (chunk < 1 || chunk > LMAX || n < 1 || n > NMAX || p % 16 || g < 1 || h % g)
    return int(cudaErrorInvalidValue);
  const Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), B, C, y,
               static_cast<float*>(state), s, h, p, g, n, chunk,
               x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg,
               c_sb, c_ss, c_sg, y_sb, y_ss, y_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_pt<float>(a, batch, device, st));
    case 1: return int(launch_pt<__nv_bfloat16>(a, batch, device, st));
    default: return int(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
