// Causal GQA flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `flash_attention_fwd` (body `_fwd_kernel`) of
// src/repro/kernels/flash_attention.py and computes what it computes:
//   s = (q . k) * D^-0.5, then softcap * tanh(s / softcap) when softcap > 0;
//   causal mask (key position > query position -> -1e30); with a window
//   W > 0 also keys at W or more positions before the query (query t attends
//   [t-W+1, t], as ref.attention_ref(window=W); the TPU kernel has no window);
//   online softmax with running max m, sum l and accumulator in f32;
//   o = acc / max(l, 1e-30), stored in q's dtype.
// GQA: query head h reads kv head h / (Hq / Hk). Both kernels read the
// public [B, S, H, D] layout through its strides (no transposed copies),
// mask the ragged tail themselves (any S), launch the heaviest query tiles
// first, and, with a window, start the key-tile loop at the tile holding the
// band's first key of the block's first query row. The window is a template
// parameter, so without one (window 0) no band test is compiled in.
//
// What bounds it on the H100. At qwen1.5-0.5b's serving shape (B=4, S=512,
// H=16, D=64, bf16) the function moves 16.8 MB and does 2.2 GFLOP: bytes
// bound it (about 5 us at 3.35 TB/s), and at that size launch and pipeline
// latency dominate. At S=4096 it is operations (0.139 ms at 989 TFLOP/s),
// and so it is in recurrentgemma-2b's band (B=4, S=4096, Hq=10, Hk=1,
// D=256, W=2048: 2.58e11 FLOP, 184.5 MB; 0.261 ms). So the products must
// run on the bf16 tensor cores, and the loads must hide behind them.
//
// bf16: the tensor-core kernel (fa_fwd_bf16_kernel). A block of two
// consumer warpgroups (256 threads) owns 128 query rows of one (batch,
// query head), 64 rows a warpgroup, and walks key/value tiles of 64 rows.
//   - Q is loaded once into shared memory; K and V go through a ring of two
//     stages, loaded with 16-byte cp.async copies by all threads, so the
//     next tile is in flight while the current one is computed. Rows past S
//     and head-dim columns past D are zero-filled by the copy (src-size 0):
//     in the tensor-core P.V, 0 x NaN would still be NaN.
//   - Every tile lies in shared memory in the 128-byte-swizzled layout that
//     wgmma's descriptors read: column blocks of 64 elements, each row of a
//     block 128 bytes, 16-byte chunk c of row r stored at chunk c ^ (r % 8).
//     Q and K are read K-major (along D); V is the same bytes read MN-major
//     (transposed B), so one loader serves all three.
//   - S = Q K^T: wgmma.mma_async m64n64k16, A = Q and B = K from shared
//     memory, f32 accumulators, D/16 K-steps. O += P V: m64n64k16 with P
//     taken from the score registers, rounded to bf16 (A in registers: the
//     score accumulator's layout is the A fragment's), and V from shared
//     memory, one instruction per 64 columns of D and per 16 keys.
//   - The online softmax stays in f32 registers: the scale multiplies the
//     scores before the softcap; m in log2 units (ex2.approx); each thread keeps
//     a partial l of its 16 columns, summed across its row's four lanes at
//     the end. Only tiles that straddle the diagonal or an edge of the band
//     evaluate the position mask; a masked probability is exactly 0, also
//     in a row whose first visited tile lies wholly outside its band (m is
//     still -1e30 there). A warpgroup skips a tile that holds no key of its
//     rows' bands, which is exact: such a tile adds p = 0 and rescales by 1.
//     With W >= S the windowed instantiation walks the same tiles in the
//     same order with the same arithmetic as the causal one, so the two are
//     bit-equal.
//   Precision: P is rounded to bf16 before P.V, as FA2 and FA3 do and as the
//   JAX model path does (src/repro/models/attention.py); the TPU kernel
//   keeps P in f32 (it casts v to f32). l sums the f32 probabilities.
//   Shared memory: Q 128 x D and two stages of K and V 64 x D, bf16, with D
//   padded to 64: 192 KB at D=256 (one block an SM), 144 KB at D=192 (12
//   k-steps of 16; three 64-column slices of O), 48 KB at D <= 64.
//   Row starts must lie on 16 bytes: the wrapper checks the pointers and the
//   strides and raises otherwise.
//
// float32: the scalar kernel (fa_fwd_kernel), unchanged from the first
// port: its 1e-5 gate cannot be held by bf16 or TF32 tensor cores, and only
// tests and checks use f32 on the card (the model serves in bf16). One block
// of 256 threads per (64 query rows, query head, batch row); each 64-row K/V
// tile is staged in shared memory as f32 (rows padded to D + 1 floats); both
// products are scalar FMAs; P.V in f32, as the TPU kernel does it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int MAX_DEVICES = 64;
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

// ---------------------------------------------------------------------------
// float32: the scalar kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per shared-memory tile
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int RN = BQ / 16;   // query rows per thread
constexpr int CN = BK / 16;   // score columns per thread

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) +
                          size_t(BK) * D + size_t(BQ) * (BK + 1));
}

template <int D, bool WINDOWED>
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

  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + hkv * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + hkv * a.v_sh;
  float* og = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D, s = q0 + r;
    qs[r * LD + c] = s < a.s ? qg[s * a.q_ss + c] : 0.f;
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
      ks[r * LD + c] = in ? kg[s * a.k_ss + c] : 0.f;
      vs[r * D + c] = in ? vg[s * a.v_ss + c] : 0.f;
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
      for (int c = 0; c < DN; ++c) og[s * a.o_ss + tx + 16 * c] = acc[i][c] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int TC_WG = 2;              // consumer warpgroups per block
constexpr int TC_THREADS = 128 * TC_WG;
constexpr int TC_BQ = 64 * TC_WG;     // query rows per block, 64 a warpgroup
constexpr int TC_BK = 64;             // key rows per tile, one m64n64 score product
                                      // (128 lowers occupancy: slower at D=64)
constexpr int TC_STAGES = 2;          // K/V ring (the loop's `& 1` and `^ 1` assume two)
constexpr float LOG2E = 1.4426950408889634f;

// shared-memory width of a row: D padded to the 64-element swizzle atom
template <int D>
__host__ __device__ constexpr int padded_d() { return D < 64 ? 64 : D; }

template <int D>
constexpr size_t tc_smem_bytes() {
  // Q, then the stages' K and V, plus slack to align the base on 1024 bytes
  return size_t(2) * padded_d<D>() * (TC_BQ + 2 * TC_STAGES * TC_BK) + 1024;
}

template <int D, bool WINDOWED>
__global__ void __launch_bounds__(TC_THREADS, 1) fa_fwd_bf16_kernel(const Args a) {
  constexpr int DP = padded_d<D>();
  constexpr int NB = DP / 64;                 // 64-column slices of O
  constexpr uint32_t Q_BYTES = TC_BQ * DP * 2;
  constexpr uint32_t KV_BYTES = TC_BK * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  // Q, then the K/V stages, from a 1024-byte boundary (the swizzle's period)
  const uint32_t qs = (smem_addr(smem_raw) + 1023) & ~1023u;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = h / (a.hq / a.hk);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int q0 = qt * TC_BQ;
  const int wq0 = q0 + 64 * wg;                       // the warpgroup's first row
  const int wq1 = min(wq0 + 63, a.s - 1);             // and its last valid row
  const int row = wq0 + 16 * warp + (lane >> 2);      // this thread's rows: row, row + 8
  const int col = 2 * (lane & 3);                     // and columns 8 n + col + {0, 1}

  using bf16 = __nv_bfloat16;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb + hkv * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb + hkv * a.v_sh;
  bf16* og = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;

  // key tiles from the one holding the band's first key of row q0 (0 without
  // a window) to the one holding the block's last valid query row
  const int kt0 = WINDOWED ? max(0, q0 - a.window + 1) / TC_BK : 0;
  const int n_kv = (min(q0 + TC_BQ, a.s) - 1) / TC_BK + 1;

  load_tile<DP, TC_BQ, TC_THREADS>(qs, qg, a.q_ss, q0, a.s, D, tid);
  load_tile<DP, TC_BK, TC_THREADS>(qs + Q_BYTES, kg, a.k_ss, kt0 * TC_BK, a.s, D, tid);
  load_tile<DP, TC_BK, TC_THREADS>(qs + Q_BYTES + KV_BYTES, vg, a.v_ss, kt0 * TC_BK, a.s, D, tid);
  cp_async_commit();

  // Q K-major: this warpgroup's 64 rows, 8-row groups 1024 bytes apart
  const uint64_t q_desc = sw128_desc(qs + wg * 64 * 128, 16, 1024);
  float o[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float qk_scale = a.softcap > 0.f ? a.scale : a.scale * LOG2E;

  for (int kt = kt0; kt < n_kv; ++kt) {
    const int st = (kt - kt0) & 1;
    const uint32_t ks = qs + Q_BYTES + st * 2 * KV_BYTES;
    const uint32_t vs = ks + KV_BYTES;
    if (kt + 1 < n_kv) {  // the next tile into the other stage, in flight meanwhile
      const uint32_t nks = qs + Q_BYTES + (st ^ 1) * 2 * KV_BYTES;
      load_tile<DP, TC_BK, TC_THREADS>(nks, kg, a.k_ss, (kt + 1) * TC_BK, a.s, D, tid);
      load_tile<DP, TC_BK, TC_THREADS>(nks + KV_BYTES, vg, a.v_ss, (kt + 1) * TC_BK, a.s, D, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();  // this stage (and Q) landed for every thread

    const int k0 = kt * TC_BK;
    // a tile with no key in the band of any of this warpgroup's rows adds
    // p = 0 and rescales by 1: skipping it is exact
    const bool active = wq0 < a.s && k0 <= wq1 &&
                        !(WINDOWED && wq0 - (k0 + TC_BK - 1) >= a.window);
    if (active) {
      const bool masked = k0 + TC_BK - 1 > wq0 || (WINDOWED && wq1 - k0 >= a.window);
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      // S = Q K^T over D / 16 K-steps: 32 bytes (2 units of the descriptor)
      // along a row within a column block, then the next column block
      const uint64_t k_desc = sw128_desc(ks, 16, 1024);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, q_desc + (kk >> 2) * (TC_BQ * 128 / 16) + (kk & 3) * 2,
                 k_desc + (kk >> 2) * (TC_BK * 128 / 16) + (kk & 3) * 2, kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // online softmax; sc[4 n + 2 i + j] is row row + 8 i, column 8 n + col + j
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = row + 8 * i;
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float x = sc[4 * n + 2 * i + j] * qk_scale;
            if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap) * LOG2E;
            if (masked) {
              const int kpos = k0 + 8 * n + col + j;
              if (kpos > qpos || (WINDOWED && qpos - kpos >= a.window)) x = NEG_INF;
            }
            sc[4 * n + 2 * i + j] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        corr[i] = fast_exp2(m[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float x = sc[4 * n + 2 * i + j];
            const float p = x == NEG_INF ? 0.f : fast_exp2(x - m_new);
            sc[4 * n + 2 * i + j] = p;
            rs += p;
          }
        l[i] = l[i] * corr[i] + rs;  // this thread's 16 columns; summed at the end
        m[i] = m_new;
      }

      // P in bf16 as the A fragments of the 4 K-steps of P V: the score
      // accumulator of columns 16 kk .. 16 kk + 15 is that fragment's layout
      uint32_t pa[TC_BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 32; ++e) o[nb][e] *= corr[(e >> 1) & 1];
        fence_regs(o[nb]);
      }
      // O += P V: V MN-major, 16 keys (2048 bytes) a K-step, 64 columns a slice
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          wgmma_rs(o[nb], pa[kk],
                   sw128_desc(vs + nb * (TC_BK * 128) + kk * 2048, TC_BK * 128, 1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
    }
    __syncthreads();  // both warpgroups are done with this stage before it is reloaded
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int s = row + 8 * i;
    if (s < a.s) {
      const float denom = fmaxf(lt, 1e-30f);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c = 64 * nb + 8 * n + col;
          if (c < D)
            *reinterpret_cast<uint32_t*>(og + s * a.o_ss + c) =
                pack_bf16(o[nb][4 * n + 2 * i] / denom, o[nb][4 * n + 2 * i + 1] / denom);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Raises a kernel's shared-memory limit once per device, not on every launch
// (prefill is host-bound: each runtime call counts).
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

template <int D, bool WINDOWED>
cudaError_t launch_f32(const Args& a, int batch, int device, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const cudaError_t err = set_smem_once(smem_set, fa_fwd_kernel<D, WINDOWED>, device, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + BQ - 1) / BQ, a.hq, batch);
  fa_fwd_kernel<D, WINDOWED><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool WINDOWED>
cudaError_t launch_bf16(const Args& a, int batch, int device, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const cudaError_t err = set_smem_once(smem_set, fa_fwd_bf16_kernel<D, WINDOWED>, device, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + TC_BQ - 1) / TC_BQ, a.hq, batch);
  fa_fwd_bf16_kernel<D, WINDOWED><<<grid, TC_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool BF16, int D, bool WINDOWED>
cudaError_t launch(const Args& a, int batch, int device, cudaStream_t stream) {
  return BF16 ? launch_bf16<D, WINDOWED>(a, batch, device, stream)
              : launch_f32<D, WINDOWED>(a, batch, device, stream);
}

template <bool BF16, bool WINDOWED>
cudaError_t launch_d(const Args& a, int batch, int d, int device, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<BF16, 16, WINDOWED>(a, batch, device, stream);
    case 32: return launch<BF16, 32, WINDOWED>(a, batch, device, stream);
    case 64: return launch<BF16, 64, WINDOWED>(a, batch, device, stream);
    case 128: return launch<BF16, 128, WINDOWED>(a, batch, device, stream);
    case 192: return launch<BF16, 192, WINDOWED>(a, batch, device, stream);
    case 256: return launch<BF16, 256, WINDOWED>(a, batch, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool BF16>
cudaError_t launch_w(const Args& a, int batch, int d, int device, cudaStream_t stream) {
  return a.window > 0 ? launch_d<BF16, true>(a, batch, d, device, stream)
                      : launch_d<BF16, false>(a, batch, d, device, stream);
}

}  // namespace

extern "C" {

// device: the caller's current CUDA device (the one the tensors and the
// stream belong to); this function does not change the current device.
// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor-core kernel; the
// pointers on 16 bytes and the batch, sequence and head strides multiples
// of 8). Strides are in elements; the last dim of q, k, v and o is
// contiguous. d: 16, 32, 64, 128, 192 or 256 (the wrapper runs D = 8 here
// zero-padded to 16, with the true D's scale). window: 0 for none, else W > 0 (query t attends keys
// [t-W+1, t]). Returns the CUDA error code of the launch.
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
    case 0: return int(launch_w<false>(a, batch, d, device, st));
    case 1: return int(launch_w<true>(a, batch, d, device, st));
    default: return int(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
