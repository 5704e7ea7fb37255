// Causal GQA flash attention for Hopper (sm_90a), float32 arithmetic.
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py:28 (`flash_attention`):
// online-softmax attention with an optional sliding window and tanh
// soft-cap, skipping KV tiles that no query of the tile can see.
//
// What it must reproduce (the reference's own choices):
//   * scores are scaled after the dot product, then soft-capped
//     (cap * tanh(s / cap)), then masked;
//   * the mask value is the finite NEG = -1e30, not -inf: a row that is
//     fully masked within a live tile gets p = exp(NEG - NEG) = 1, which
//     corr = exp(NEG - m_real) = 0 wipes once a real score arrives (with
//     -inf it would be NaN); l == 0 becomes 1 at the end;
//   * GQA: query head h reads KV head h / (H / KV);
//   * query i sits at key position i (Sq == Sk; the wrapper checks it).
//
// Design (first version: simple and right).  One block of 256 threads per
// (q tile of 64 rows, head, batch); a loop over the KV tiles of 64 keys from
// the first one the window lets in to the diagonal one takes the place of
// the Pallas grid's sequential fourth axis.  Q, K, V and the score tile are
// staged in shared memory as float32 (inputs are float32 or bfloat16); the
// running max m and sum l live in shared memory, the accumulator in
// registers (a 4 x D/16 micro-tile per thread).  The last q tile may be
// ragged: rows and keys past S are zero-filled and never stored, so any
// sequence length is taken.  Tiles are visited heaviest first (the q tiles
// near the end of the sequence have the most live KV tiles).
//
// What bounds it on this card: at the serving shape (B=8, H=32, S=1024,
// D=64) the causal work is 4*B*H*S^2*D/2 = 3.4e10 float32 operations against
// 0.15 GB of inputs and output, so the floor is the operations: 0.51 ms at
// 67 TFLOP/s (float32 outside the tensor cores) against 0.045 ms for the
// bytes.  This version runs on the CUDA cores from shared memory, and each
// multiply-add reads one operand from shared memory (a 4 x 4 register tile
// per thread, 8 loads per 16 FMAs), so shared-memory bandwidth, not the FMA
// rate, is its limit.  The tensor cores (TF32 or bf16 wgmma), TMA loads and
// warp specialisation are the later steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per KV tile
constexpr int THREADS = 256;   // a 16 x 16 grid of threads
constexpr int PS = BK + 1;     // padded row stride of the score tile
constexpr float NEG = -1e30f;

struct Strides {               // in elements; the head dimension has stride 1
  long long q[3], k[3], v[3], o[3];   // batch, head, sequence
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_floats() {
  // Q and K padded to D + 1 (conflict-free column reads), V, scores, and
  // three per-row arrays (corr, m, l).
  return 2 * BQ * (D + 1) + BK * D + BQ * PS + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int KV, int S,
             int window, float cap, float scale, Strides st) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int RD = D / 16;          // accumulator columns per thread
  float* Qs = smem;                   // [BQ][DP]
  float* Ks = Qs + BQ * DP;           // [BK][DP]
  float* Vs = Ks + BK * DP;           // [BK][D]
  float* Ps = Vs + BK * D;            // [BQ][PS]
  float* corr_s = Ps + BQ * PS;       // [BQ]
  float* m_s = corr_s + BQ;           // [BQ]
  float* l_s = m_s + BQ;              // [BQ]

  const int nq = (S + BQ - 1) / BQ;
  const int q_lo = (nq - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + kvh * st.k[1];
  const T* vb = v + b * st.v[0] + kvh * st.v[1];
  T* ob = o + b * st.o[0] + h * st.o[1];

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = q_lo + r;
    Qs[r * DP + c] = row < S ? to_f32(qb[row * st.q[2] + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  float acc[4][RD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  // Live KV tiles: from the one holding the first key that row q_lo may
  // see (q_lo - window + 1) to the one holding the last row's own key.
  const int q_hi = min(q_lo + BQ - 1, S - 1);
  const int j_lo = window ? max(0, q_lo - window + 1) / BK : 0;
  const int j_hi = q_hi / BK;

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int k_lo = jt * BK;
    __syncthreads();   // the previous tile's readers of Ks, Vs, Ps are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx % D, key = k_lo + r;
      const bool in = key < S;
      Ks[r * DP + c] = in ? to_f32(kb[key * st.k[2] + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[key * st.v[2] + c]) : 0.f;
    }
    __syncthreads();

    // Scores: this thread's rows ty + 16 i and columns tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float x = s[i][j] * scale;
        if (cap != 0.f) x = cap * tanhf(x / cap);
        const int qpos = q_lo + r, kpos = k_lo + c;
        bool keep = qpos >= kpos;
        if (window) keep = keep && (qpos - kpos) < window;
        Ps[r * PS + c] = keep ? x : NEG;
      }
    }
    __syncthreads();

    // Online softmax: each warp takes 8 rows, each lane two columns.
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float a = Ps[r * PS + lane], c = Ps[r * PS + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      Ps[r * PS + lane] = pa;
      Ps[r * PS + lane + 32] = pc;
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = corr_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[RD];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < RD; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();   // l_s holds every row's final sum

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q_lo + r;
    if (row >= S) continue;
    float l = l_s[r];
    if (l == 0.f) l = 1.f;
#pragma unroll
    for (int j = 0; j < RD; ++j)
      store(&ob[row * st.o[2] + tx + 16 * j], acc[i][j] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int S, int window, float cap,
                   const Strides& st, cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  auto kernel = flash_kernel<T, D>;
  // Above 48 KB of shared memory a launch is refused unless the kernel is
  // allowed more; D = 64 takes 67 KB, D = 128 116 KB.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, S, window, cap,
      scale, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int H, int KV, int S, int window,
                     float cap, const Strides& st, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KV, S, window, cap, st, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, S, window, cap, st, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, S, window, cap, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: [B, H, S, D]; k, v: [B, KV, S, D], addressed through `strides`
// (12 int64: batch, head and sequence strides of q, k, v, o, in elements;
// the head dimension is contiguous).  dtype 0 = float32, 1 = bfloat16.
// Returns the launch's cudaGetLastError() (0 on success).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int dtype, int B, int H, int KV, int S,
                          int D, int window, float cap,
                          const long long* strides, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? dispatch<float>(D, q, k, v, o, B, H, KV, S, window, cap, st, s)
          : dtype == 1 ? dispatch<__nv_bfloat16>(D, q, k, v, o, B, H, KV, S,
                                                 window, cap, st, s)
                       : cudaErrorInvalidValue;
  return (int)err;
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
