// Mamba2 SSD chunked scan (forward) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `ssd_scan_chunked` (body `_ssd_kernel`) of
// src/repro/kernels/ssd_scan.py together with its wrapper `ops.ssd_scan`
// (src/repro/kernels/ops.py), and computes what they compute: for each
// chunk of L steps, with xdt = x * dt, dA = dt * A, cs = cumsum(dA)
//   y_diag = (C B^T * Lmat) xdt       Lmat[i,j] = exp(cs_i - cs_j), i >= j
//   y_off  = exp(cs) * (C state)
//   state <- exp(cs_last) state + (B * exp(cs_last - cs))^T xdt
// y = y_diag + y_off is stored in x's dtype. Unlike the TPU kernel it also
// writes the final state [b, h, n, p] in f32, which the prefill cache needs.
// Both kernels read x [b, s, h, p], dt [b, s, h] and B, C [b, s, g, n] in
// their public layout through strides (head hd reads group hd / (h / g)):
// no padded, repeated or transposed copies, unlike the TPU wrapper, which
// materialises B and C repeated over the heads in f32. Steps past s read
// dt = 0 and B = C = x = 0, so they leave the state unchanged, and their y
// is never stored. The TPU kernel carries the state along a sequential chunk
// axis of its grid; here blocks run in no order, so a block owns one (batch
// row, head, tile of p columns) (column q of y depends only on column q of
// xdt and of the state) and walks the chunks itself, the state on chip.
//
// What bounds it. At the serving shape (b=4, s=2048, h=32, p=64, n=128,
// L=128, bf16) the function moves 76.5 MB and does 21.5 GFLOP, so the card's
// bound is bytes, barely (about 23 us at 3.35 TB/s against 22 us at the bf16
// tensor peak). The products must run on the tensor cores to come near it:
// at the f32 CUDA-core rate the same work takes at least 0.32 ms.
//
// bf16: the tensor-core kernel (ssd_bf16_kernel). Within a chunk the SSD is
// causal attention without the softmax: C plays Q, B plays K, xdt plays V,
// and the decay exp(cs_i - cs_j) takes the softmax's place. A block of two
// warpgroups (256 threads) owns 64 columns of p (zero-padded past p); the
// chunk's 128 rows (L <= 128, zero-padded) are split 64 a warpgroup for y,
// and the state's 128 rows (n <= 128, zero-padded) 64 a warpgroup.
//   - C, B (128 x 128), x (128 x 64) and dt of the next chunk go through a
//     two-stage cp.async ring while the current one is computed. Tiles lie in
//     the 128-byte-swizzled layout of hopper.cuh.
//   - Per chunk, four products on wgmma m64n64k16 with f32 accumulators:
//     1. S = C B^T, C and B K-major (exact: B and C are bf16); a warpgroup
//        skips the 64-key tile above its rows;
//     2. y_diag = P xdt, P = S * Lmat rounded to bf16 in registers (the
//        score accumulator is the A fragment, as P in flash attention) and
//        xdt = x * dt rounded to bf16 in shared memory, read MN-major;
//     3. y_off = exp(cs) * (C state): the f32 state is split into a bf16 hi
//        part and a bf16 lo part (state - hi) in shared memory, one wgmma
//        each, so the product keeps about 16 bits of the state;
//     4. state <- exp(cs_last) state + B^T u, u = exp(cs_last - cs) * x * dt
//        in f32 split into hi and lo the same way; B^T is B's tile read
//        MN-major (the A-transpose bit). The state's accumulator stays in
//        f32 registers across chunks; its hi/lo copy feeds step 3 of the
//        next chunk, and the block writes the final state in f32.
//   Precision: xdt and C B^T * Lmat are rounded to bf16 before the
//   intra-chunk product, exactly the JAX model path's two roundings
//   (src/repro/models/ssm.py:64,77; `ops.ssd_scan_plain(round_to=)` repeats
//   them); the state path keeps f32 through the hi/lo split (a single bf16 or
//   a TF32 rounding there misses the state's 1e-4 gate). The TPU kernel keeps
//   everything in f32.
//   Shared memory: two stages of C, B and x (160 KB), the state's and u's
//   hi/lo (64 KB), dt and cs: 226.5 KB with the alignment slack, of the 227
//   KB a block may have; one block an SM (128 blocks at the serving shape).
//   Rows must start on 16 bytes: the wrapper checks the pointers and the
//   strides and raises otherwise.
//
// float32: the scalar kernel (ssd_f32_kernel), unchanged from the first port:
// its 1e-4 gate cannot be held by bf16 or TF32 tensor cores, and only tests
// and checks use f32 on the card (the model serves in bf16). One block of
// 256 threads per (batch * head, tile of PT columns of p) keeps its [n, PT]
// state in shared memory; per chunk it stages B^T, C and its xdt columns in
// f32, then computes the L x L scores in row strips of 32 (only the columns
// under the diagonal), all as scalar FMAs: with L = n = 128 and PT = 64 it
// uses 210 KB of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int MAX_DEVICES = 64;
constexpr int LMAX = 128;  // longest chunk
constexpr int NMAX = 128;  // largest state

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

// ---------------------------------------------------------------------------
// float32: the scalar kernel
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int RS = 32;     // rows of a score strip

// Floats of shared memory for a chunk of L steps, a state of n and PT columns.
__host__ __device__ constexpr size_t smem_floats(int L, int n, int pt) {
  return size_t(n) * (L + 1)      // bt: B^T of the chunk, rows padded
         + size_t(L) * (n + 1)    // cm: C of the chunk, rows padded
         + size_t(L) * pt         // xd: x * dt, this block's columns
         + size_t(n) * pt         // st: the carried state
         + size_t(RS) * (L + 1)   // ps: one strip of decayed, masked scores
         + size_t(L);             // cs: inclusive cumsum of dt * A
}

template <int PT>
__global__ void __launch_bounds__(THREADS, 1) ssd_f32_kernel(const Args a) {
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

  const float* xg = static_cast<const float*>(a.x) + b * a.x_sb + hd * a.x_sh + p0;
  const float* dtg = a.dt + b * a.dt_sb + hd * a.dt_sh;
  const float* bg = static_cast<const float*>(a.B) + b * a.b_sb + grp * a.b_sg;
  const float* cg = static_cast<const float*>(a.C) + b * a.c_sb + grp * a.c_sg;
  float* yg = static_cast<float*>(a.y) + b * a.y_sb + hd * a.y_sh + p0;
  const float A = a.A[hd];

  for (int e = tid; e < N * PT; e += THREADS) st[e] = 0.f;

  const int n_chunks = (a.s + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < L * N; e += THREADS) {
      const int l = e / N, k = e % N, t = t0 + l;
      const bool in = t < a.s;
      bt[k * LB + l] = in ? bg[t * a.b_ss + k] : 0.f;
      cm[l * NB + k] = in ? cg[t * a.c_ss + k] : 0.f;
    }
    for (int e = tid; e < L * PT; e += THREADS) {
      const int l = e / PT, q = e % PT, t = t0 + l;
      xd[e] = t < a.s ? xg[t * a.x_ss + q] * dtg[t * a.dt_ss] : 0.f;
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
              yg[t * a.y_ss + tx + 16 * cc] = acc[ii][cc];
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

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 256;  // two warpgroups
constexpr int TC_L = 128;        // chunk rows a stage holds (LMAX)
constexpr int TC_N = 128;        // state rows a stage holds (NMAX)
constexpr int TC_P = 64;         // columns of p a block owns
constexpr float LOG2E = 1.4426950408889634f;

constexpr uint32_t CB_BYTES = TC_L * TC_N * 2;        // C or B of a chunk
constexpr uint32_t X_BYTES = TC_L * TC_P * 2;         // x, then xdt, of a chunk
constexpr uint32_t STAGE_BYTES = 2 * CB_BYTES + X_BYTES;
constexpr uint32_t ST_BYTES = TC_N * TC_P * 2;        // hi or lo of the state
constexpr uint32_t U_BYTES = TC_L * TC_P * 2;         // hi or lo of u
constexpr uint32_t OFF_ST_HI = 2 * STAGE_BYTES;
constexpr uint32_t OFF_ST_LO = OFF_ST_HI + ST_BYTES;
constexpr uint32_t OFF_U_HI = OFF_ST_LO + ST_BYTES;
constexpr uint32_t OFF_U_LO = OFF_U_HI + U_BYTES;
constexpr uint32_t OFF_DT = OFF_U_LO + U_BYTES;       // two stages of dt, f32
constexpr uint32_t OFF_CS = OFF_DT + 2 * TC_L * 4;    // cs * log2(e), f32
// plus slack to align the base on 1024 bytes (the swizzle's period)
constexpr size_t TC_SMEM = OFF_CS + TC_L * 4 + 1024;
static_assert(TC_SMEM <= 232448, "more shared memory than a block may have");

// descriptor of the 16-row K-step kk of an MN-major operand in a swizzled
// tile of 128 rows (64 columns of the MN dimension)
__device__ __forceinline__ uint64_t mn_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 2048, 128 * 128, 1024);
}

// descriptor of rows row0.. (64 of them) at K-step kk of a K-major operand
// in a swizzled tile of 128 rows: 32 bytes a step within a 64-column block
__device__ __forceinline__ uint64_t k_desc(uint32_t tile, int row0, int kk) {
  return sw128_desc(tile + (kk >> 2) * (128 * 128) + row0 * 128 + (kk & 3) * 32, 16, 1024);
}

__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

__global__ void __launch_bounds__(TC_THREADS, 1) ssd_bf16_kernel(const Args a) {
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // the same bytes, generic pointer
  float* dts = reinterpret_cast<float*>(gbase + OFF_DT);
  float* cs2 = reinterpret_cast<float*>(gbase + OFF_CS);

  const int bh = blockIdx.x;
  const int b = bh / a.h, hd = bh % a.h;
  const int p0 = blockIdx.y * TC_P;
  const int grp = hd / (a.h / a.g);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row = 64 * wg + 16 * warp + (lane >> 2);  // accumulator rows row, row + 8
  const int col = 2 * (lane & 3);                     // and columns 8 n + col + {0, 1}
  const int L = a.L, N = a.n;

  const bf16* xg = static_cast<const bf16*>(a.x) + b * a.x_sb + hd * a.x_sh + p0;
  const float* dtg = a.dt + b * a.dt_sb + hd * a.dt_sh;
  const bf16* bg = static_cast<const bf16*>(a.B) + b * a.b_sb + grp * a.b_sg;
  const bf16* cg = static_cast<const bf16*>(a.C) + b * a.c_sb + grp * a.c_sg;
  bf16* yg = static_cast<bf16*>(a.y) + b * a.y_sb + hd * a.y_sh + p0;
  const float A2 = a.A[hd] * LOG2E;
  const int pcols = a.p - p0;                 // valid columns of this block's tile
  const int n_chunks = (a.s + L - 1) / L;
  const int nk = (N + 15) / 16;               // K-steps over the state
  const int lk = (L + 15) / 16;               // K-steps over a chunk's steps
  const bool st_active = 64 * wg < N;         // this warpgroup owns state rows

  auto load_chunk = [&](int c, int stage) {
    const int t0 = c * L, t_end = min(t0 + L, a.s);
    const uint32_t cs_tile = base + stage * STAGE_BYTES;
    load_tile<TC_N, TC_L, TC_THREADS>(cs_tile, cg, a.c_ss, t0, t_end, N, tid);
    load_tile<TC_N, TC_L, TC_THREADS>(cs_tile + CB_BYTES, bg, a.b_ss, t0, t_end, N, tid);
    load_tile<TC_P, TC_L, TC_THREADS>(cs_tile + 2 * CB_BYTES, xg, a.x_ss, t0, t_end, pcols, tid);
    if (tid < TC_L) {
      const bool in = t0 + tid < t_end;
      cp_async4(base + OFF_DT + (stage * TC_L + tid) * 4, in ? dtg + (t0 + tid) * a.dt_ss : dtg,
                in ? 4 : 0);
    }
    cp_async_commit();
  };

  // the state entering the first chunk is 0
  for (int e = tid; e < 2 * ST_BYTES / 16; e += TC_THREADS)
    reinterpret_cast<uint4*>(gbase + OFF_ST_HI)[e] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  float st[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) st[e] = 0.f;

  load_chunk(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int stage = c & 1;
    const int t0 = c * L;
    const uint32_t c_tile = base + stage * STAGE_BYTES;
    const uint32_t b_tile = c_tile + CB_BYTES;
    const uint32_t x_tile = b_tile + CB_BYTES;
    if (c + 1 < n_chunks) {  // the next chunk into the other stage, in flight meanwhile
      load_chunk(c + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();  // this stage landed for every thread

    const float* dtc = dts + stage * TC_L;
    if (tid < 32) {  // cs2 = inclusive cumsum of dt * A, in log2 units: 4 rows a lane
      float v[4], run = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        run += dtc[4 * tid + i] * A2;
        v[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) cs2[4 * tid + i] = incl - run + v[i];
    }
    __syncthreads();

    // x -> xdt = bf16(x * dt) in place; u = exp(cs_last - cs) * x * dt as hi + lo
    // (rows past the chunk have dt = 0, so cs2[TC_L - 1] is the chunk's last)
    const float last2 = cs2[TC_L - 1];
    for (int e = tid; e < TC_L * TC_P / 8; e += TC_THREADS) {
      const int r = e >> 3;
      const uint32_t off = r * 128 + (((e & 7) ^ (r & 7)) << 4);
      const float w = dtc[r], dec = fast_exp2(last2 - cs2[r]);
      uint4 xv = *reinterpret_cast<const uint4*>(gbase + stage * STAGE_BYTES + 2 * CB_BYTES + off);
      uint4 hv, lv;
      bf16* xe = reinterpret_cast<bf16*>(&xv);
      bf16* he = reinterpret_cast<bf16*>(&hv);
      bf16* le = reinterpret_cast<bf16*>(&lv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = __bfloat162float(xe[i]) * w;
        xe[i] = __float2bfloat16_rn(v);
        split_bf16(v * dec, he[i], le[i]);
      }
      *reinterpret_cast<uint4*>(gbase + stage * STAGE_BYTES + 2 * CB_BYTES + off) = xv;
      *reinterpret_cast<uint4*>(gbase + OFF_U_HI + off) = hv;
      *reinterpret_cast<uint4*>(gbase + OFF_U_LO + off) = lv;
    }
    fence_proxy_async();
    __syncthreads();  // xdt, u and cs are ready

    // this warpgroup's y rows hold a step of the chunk below s
    const bool y_active = 64 * wg < min(L, a.s - t0);
    float o[32], sc[2][32];
    if (y_active) {
      fence_regs(o);
      fence_regs(sc[0]);
      fence_regs(sc[1]);
    }
    if (st_active) {
      const float dec_last = fast_exp2(last2);
#pragma unroll
      for (int e = 0; e < 32; ++e) st[e] *= dec_last;
      fence_regs(st);
    }
    wgmma_fence();
    if (y_active) {
      // y_off (before its exp(cs) row scale) = C . (state_hi + state_lo)
#pragma unroll
      for (int kk = 0; kk < TC_N / 16; ++kk)
        if (kk < nk) wgmma_ss<0, 1>(o, k_desc(c_tile, 64 * wg, kk), mn_desc(base + OFF_ST_HI, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < TC_N / 16; ++kk)
        if (kk < nk) wgmma_ss<0, 1>(o, k_desc(c_tile, 64 * wg, kk), mn_desc(base + OFF_ST_LO, kk), 1);
      // S = C B^T over the key tiles at or below this warpgroup's rows
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        if (kt > wg) continue;
#pragma unroll
        for (int kk = 0; kk < TC_N / 16; ++kk)
          if (kk < nk) wgmma_ss(sc[kt], k_desc(c_tile, 64 * wg, kk), k_desc(b_tile, 64 * kt, kk), kk > 0);
      }
    }
    if (st_active) {
      // state += B^T (u_hi + u_lo): A = B's tile MN-major, this warpgroup's state rows
#pragma unroll
      for (int kk = 0; kk < TC_L / 16; ++kk)
        if (kk < lk) wgmma_ss<1, 1>(st, mn_desc(b_tile + wg * (TC_L * 128), kk), mn_desc(base + OFF_U_HI, kk), 1);
#pragma unroll
      for (int kk = 0; kk < TC_L / 16; ++kk)
        if (kk < lk) wgmma_ss<1, 1>(st, mn_desc(b_tile + wg * (TC_L * 128), kk), mn_desc(base + OFF_U_LO, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    if (st_active) fence_regs(st);

    if (y_active) {
      fence_regs(o);
      fence_regs(sc[0]);
      fence_regs(sc[1]);
      float cr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) cr[i] = cs2[row + 8 * i];
      // y_off's row scale exp(cs); o[4 n + 2 i + j] is row row + 8 i
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float e = fast_exp2(cr[i]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[4 * n + 2 * i] *= e;
          o[4 * n + 2 * i + 1] *= e;
        }
      }
      // P = S * exp(cs_i - cs_j) for keys j <= i, else 0, packed to bf16 as the
      // A fragments of P xdt: 4 K-steps of 16 keys a key tile
      uint32_t pa[8][4];
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        if (kt > wg) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float pv[2][2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = 64 * kt + 8 * n + col + j;
            const float ck = cs2[k];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              pv[i][j] = k <= row + 8 * i ? sc[kt][4 * n + 2 * i + j] * fast_exp2(cr[i] - ck) : 0.f;
          }
          // sc[4 n + 2 i + j] -> fragment register 2 (n % 2) + i of K-step n / 2
#pragma unroll
          for (int i = 0; i < 2; ++i) pa[4 * kt + (n >> 1)][2 * (n & 1) + i] = pack_bf16(pv[i][0], pv[i][1]);
        }
      }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        if (kt > wg) continue;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, pa[4 * kt + kk], mn_desc(x_tile, 4 * kt + kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int l = row + 8 * i, t = t0 + l;
        if (l < L && t < a.s) {
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int q = 8 * n + col;
            if (q < pcols)
              *reinterpret_cast<uint32_t*>(yg + t * a.y_ss + q) =
                  pack_bf16(o[4 * n + 2 * i], o[4 * n + 2 * i + 1]);
          }
        }
      }
    }

    __syncthreads();  // every warpgroup has read the state's hi/lo
    if (st_active) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const uint32_t off = tile_offset<TC_N>(row + 8 * i, 8 * n + col);
          __nv_bfloat162 hi, lo;
          split_bf16(st[4 * n + 2 * i], hi.x, lo.x);
          split_bf16(st[4 * n + 2 * i + 1], hi.y, lo.y);
          *reinterpret_cast<__nv_bfloat162*>(gbase + OFF_ST_HI + off) = hi;
          *reinterpret_cast<__nv_bfloat162*>(gbase + OFF_ST_LO + off) = lo;
        }
    }
    fence_proxy_async();
    __syncthreads();  // this stage and the state's hi/lo are free for the next chunk
  }

  if (st_active) {
    float* sg = a.state + (size_t(bh) * N) * a.p + p0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = row + 8 * i;
      if (k >= N) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int q = 8 * n + col;
        if (q < pcols) {
          sg[k * a.p + q] = st[4 * n + 2 * i];
          sg[k * a.p + q + 1] = st[4 * n + 2 * i + 1];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Raises a kernel's shared-memory limit once per device, not on every launch.
template <typename Kernel>
cudaError_t set_smem_once(std::atomic<bool> (&done)[MAX_DEVICES], Kernel kernel, int device,
                          size_t smem) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[device].load(std::memory_order_acquire)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    done[device].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

template <int PT>
cudaError_t launch_f32(const Args& a, int batch, int device, cudaStream_t stream) {
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const cudaError_t err = set_smem_once(smem_set, ssd_f32_kernel<PT>, device,
                                        sizeof(float) * smem_floats(LMAX, NMAX, PT));
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * smem_floats(a.L, a.n, PT);
  const dim3 grid(batch * a.h, a.p / PT);
  ssd_f32_kernel<PT><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const Args& a, int batch, int device, cudaStream_t stream) {
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const cudaError_t err = set_smem_once(smem_set, ssd_bf16_kernel, device, TC_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.h, (a.p + TC_P - 1) / TC_P);
  ssd_bf16_kernel<<<grid, TC_THREADS, TC_SMEM, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_f32_pt(const Args& a, int batch, int device, cudaStream_t stream) {
  if (a.p % 64 == 0) return launch_f32<64>(a, batch, device, stream);
  if (a.p % 32 == 0) return launch_f32<32>(a, batch, device, stream);
  if (a.p % 16 == 0) return launch_f32<16>(a, batch, device, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// device: the caller's current CUDA device (the one the tensors and the
// stream belong to); this function does not change the current device.
// dtype of x, B, C and y: 0 = float32 (scalar kernel), 1 = bfloat16
// (tensor-core kernel; x, B and C start on 16 bytes and their batch,
// sequence and head/group strides are multiples of 8); dt and A are float32.
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
    case 0: return int(launch_f32_pt(a, batch, device, st));
    case 1: return int(launch_bf16(a, batch, device, st));
    default: return int(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
