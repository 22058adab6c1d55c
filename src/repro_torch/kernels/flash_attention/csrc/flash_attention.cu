// flash_attention.cu — FlashAttention forward for sm_90a, written by hand.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/flash_attention/kernel.py
// (`_fa_kernel`, launched by `flash_attention`, kernel.py:35-95).  Same function:
//   q (B,H,Sq,hd), k/v (B,KV,Sk,hd); GQA maps head h to KV head h / (H/KV);
//   scores in f32; causal mask qpos >= kpos (both from 0), masked scores set
//   to finfo(f32).min; online softmax with m, l and acc in f32; a row whose
//   l is 0 outputs 0; the output is in q's dtype.
//
// Bound on this card.  At the serve slice's shape (bf16, q (4,16,2048,128),
// k/v (4,8,2048,128), causal) the work is 4*B*H*S(S+1)/2*hd = 68.7 GFLOP,
// 69 us at the bf16 tensor-core peak of 989 TFLOP/s, against 100.7 MB of
// bytes (30 us at 3.35 TB/s): the kernel is bound by operations, and only
// the tensor cores reach that rate.  At stablelm-3b's and zamba2-2.7b's shape
// (q (4,32,2048,80), k/v (4,32,2048,80), causal) it is 85.9 GFLOP, 87 us.
//
// bf16: the Hopper FlashAttention-3 shape, written simply.  One block per
// (b, h, 128-row query tile), the heaviest causal tiles launched first.
// Warpgroup 0 is the producer: one thread issues a TMA load of the Q tile
// and keeps a 2-stage ring of 128-key K and V tiles in flight, completion
// signalled on mbarriers; its registers go to the consumers by setmaxnreg.
// A tile lies in column blocks of the widest swizzle span (128, 64 or 32
// bytes) that divides a row: hd 128 is two 128-byte blocks, hd 80 five
// 32-byte ones.  Warpgroups 1 and 2 are consumers of 64 query rows each:
// S = Q K^T by wgmma (m64n128k16, both operands from shared memory, one
// k-step per 16 columns, f32 accumulators), the scale and log2(e) applied
// to S in f32, exp2, row max and sum over the 4 threads that share a row,
// then O += P V by wgmma (m64nHDk16) with P from registers (rounded to
// bf16: the one rounding the reference does not make) and V from shared
// memory read MN-major, its column blocks one swizzle atom apart each (the
// descriptor's leading byte offset).  Only the diagonal tile and the
// ragged last key tile are masked; tiles above the diagonal are never
// loaded.  The tensor maps are built on the host over each tensor's own
// strides, so the model's (B,S,H,hd) layout needs no transposes; TMA
// zero-fills rows past Sq or Sk, the kernel masks keys >= Sk and stores
// only rows < Sq, so any sequence length works.  The two consumers overlap
// each other's softmax and products; a consumer does not yet overlap its
// own softmax with its next product (FA-3's intra-warpgroup pipelining is
// later work).
//
// f32: the CUDA-core version (f32 FMA, no TF32, so it holds the 2e-5
// tolerance): one block per (b, h, 64-row query tile) looping over 64-key
// tiles staged through shared memory, tiles past the causal diagonal
// skipped; 128 threads, thread (ty, tx) owning 8 query rows and 4 key
// columns of each score tile.  Its ceiling is the 67 TFLOP/s f32 rate.
//
// C interface: flash_attention_launch(...) launches on the given stream,
// allocates nothing and returns cudaGetLastError(), or 1000 + the CUresult
// of cuTensorMapEncodeTiled if a tensor map cannot be encoded.  That
// function is reached through the runtime's entry-point query, so the
// library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr float NEG_INF = -FLT_MAX;  // finfo(float32).min, as the reference

struct Strides {  // in elements; head_dim has stride 1
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int TILE = 128;           // query rows per block = keys per tile
constexpr int WG_THREADS = 128;     // one warpgroup
constexpr int BF16_THREADS = 3 * WG_THREADS;  // producer + two consumers
constexpr int STAGES = 2;
constexpr int MIN_SMEM = 116 * 1024;  // > half the SM: one block per SM, so
                                      // setmaxnreg always finds its registers
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory layout of one operand tile (128 rows x HD bf16): HD/CB
// column blocks of 128 rows x SW bytes, each swizzled as TMA writes it.  The
// swizzle span is the largest of 128, 64 and 32 bytes that divides a row's
// HD*2 bytes, so the blocks cover every column: hd 80 (160-byte rows) takes
// five 32-byte blocks of 16 columns.
template <int HD>
struct Tile {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  static constexpr int SW = (HD * 2) % 128 == 0 ? 128 : (HD * 2) % 64 == 0 ? 64 : 32;
  static constexpr int CB = SW / 2;                        // columns per block
  static constexpr int CBLK = TILE * SW;                   // bytes per block
  static constexpr int BYTES = TILE * HD * 2;
  // wgmma descriptor layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle TMA_SWIZZLE =
      SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr int SMEM = 5 * BYTES + 1024 + 128;  // Q, 2 K, 2 V, align, barriers
  static constexpr int SMEM_LAUNCH = SMEM > MIN_SMEM ? SMEM : MIN_SMEM;
};

// Which coordinate (1..3) of a tensor map holds seq, head and batch: the
// three outer dims are ordered by stride.
struct Perm {
  int seq, head, batch;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.  A
// wait of more than about 10 s (a lost arrival) traps, so a fault in the
// pipeline ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets (all in 16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, f32) (+)= A (64 x 16, smem, K-major) * B (128 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 16, f32) += A (64 x 16, bf16 registers) * B (16 x 16, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D (64 x 32, f32) += A (64 x 16, bf16 registers) * B (16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D (64 x 80, f32) += A (64 x 16, bf16 registers) * B (16 x 80, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 16) wgmma_rs_n16(d, a, db, 1);
  if constexpr (HD == 32) wgmma_rs_n32(d, a, db, 1);
  if constexpr (HD == 64) wgmma_rs_n64(d, a, db, 1);
  if constexpr (HD == 80) wgmma_rs_n80(d, a, db, 1);
  if constexpr (HD == 128) wgmma_rs_n128(d, a, db, 1);
}

template <int HD>
__global__ void __launch_bounds__(BF16_THREADS, 1)
fa_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, Perm pq, Perm pk, Perm pv,
            __nv_bfloat16* __restrict__ o, Strides os, int H, int KV, int Sq, int Sk,
            float scale_log2, int causal) {
  using L = Tile<HD>;
  extern __shared__ __align__(1024) uint8_t fa_smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fa_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sQ = base;
  uint8_t* sK = base + L::BYTES;                 // [STAGES] tiles
  uint8_t* sV = base + (1 + STAGES) * L::BYTES;  // [STAGES] tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + (1 + 2 * STAGES) * L::BYTES);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* k_empty = bars + 1 + 2 * STAGES;
  uint64_t* v_empty = bars + 1 + 3 * STAGES;

  const int nq = (Sq + TILE - 1) / TILE;
  const int nbh = static_cast<int>(gridDim.x) / nq;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x) / nbh;  // heaviest causal tiles first
  const int bh = static_cast<int>(blockIdx.x) % nbh;
  const int h = bh % H;
  const int b = bh / H;
  const int hk = h / (H / KV);
  const int q0 = iq * TILE;
  const int nk_all = (Sk + TILE - 1) / TILE;
  const int nk = causal ? min(nk_all, iq + 1) : nk_all;  // tiles past the diagonal: all masked

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 2 * WG_THREADS);
      mbar_init(v_empty + s, 2 * WG_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int c[4];
      c[pq.head] = h;
      c[pq.batch] = b;
      c[pq.seq] = q0;
      mbar_expect_tx(q_full, L::BYTES);
#pragma unroll
      for (int cb = 0; cb < HD / L::CB; ++cb)
        tma_load_4d(sQ + cb * L::CBLK, &tq, q_full, cb * L::CB, c[1], c[2], c[3]);
      int ck[4], cv[4];
      ck[pk.head] = hk;
      ck[pk.batch] = b;
      cv[pv.head] = hk;
      cv[pv.batch] = b;
      for (int j = 0; j < nk; ++j) {
        const int st = j % STAGES;
        const uint32_t ph = (j / STAGES) & 1;
        ck[pk.seq] = j * TILE;
        cv[pv.seq] = j * TILE;
        if (j >= STAGES) mbar_wait(k_empty + st, ph ^ 1);
        mbar_expect_tx(k_full + st, L::BYTES);
#pragma unroll
        for (int cb = 0; cb < HD / L::CB; ++cb)
          tma_load_4d(sK + st * L::BYTES + cb * L::CBLK, &tk, k_full + st, cb * L::CB, ck[1],
                      ck[2], ck[3]);
        if (j >= STAGES) mbar_wait(v_empty + st, ph ^ 1);
        mbar_expect_tx(v_full + st, L::BYTES);
#pragma unroll
        for (int cb = 0; cb < HD / L::CB; ++cb)
          tma_load_4d(sV + st * L::BYTES + cb * L::CBLK, &tv, v_full + st, cb * L::CB, cv[1],
                      cv[2], cv[3]);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tw = threadIdx.x % WG_THREADS;
    const int lane = tw % 32;
    // accumulator layout: rows r and r + 8, columns 8 j + 2 (lane % 4) + {0, 1}
    const int row_a = q0 + cw * 64 + (tw / 32) * 16 + lane / 4;
    const int row_b = row_a + 8;
    const int col0 = (lane % 4) * 2;
    const uint32_t q_addr = smem_u32(sQ) + cw * 64 * L::SW;
    const uint32_t k_addr = smem_u32(sK);
    const uint32_t v_addr = smem_u32(sV);

    float acc[HD / 2];
    float s[TILE / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) s[i] = 0.f;
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;  // l: this thread's part

    mbar_wait(q_full, 0);
    for (int j = 0; j < nk; ++j) {
      const int st = j % STAGES;
      const uint32_t ph = (j / STAGES) & 1;
      const int k0 = j * TILE;

      // S = Q K^T (64 x 128 keys), both operands K-major in shared memory
      mbar_wait(k_full + st, ph);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk * 16 / L::CB) * L::CBLK + (kk * 16 % L::CB) * 2;
        wgmma_ss_n128(s, gmma_desc(q_addr + off, 16, 8 * L::SW, L::LAYOUT),
                      gmma_desc(k_addr + st * L::BYTES + off, 16, 8 * L::SW, L::LAYOUT),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      mbar_arrive(k_empty + st);

      // online softmax in the log2 domain
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) s[i] *= scale_log2;
      if ((causal && j == iq) || k0 + TILE > Sk) {
#pragma unroll
        for (int i = 0; i < TILE / 2; ++i) {
          const int kj = k0 + (i / 4) * 8 + col0 + (i % 2);
          const int qi = (i % 4) < 2 ? row_a : row_b;
          if (kj >= Sk) {
            s[i] = -INFINITY;  // not a key: weight 0
          } else if (causal && qi < kj) {
            s[i] = NEG_INF;
          }
        }
      }
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int i = 0; i < TILE / 8; ++i) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * i], s[4 * i + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float alpha_a = exp2_approx(m_a - mx_a);
      const float alpha_b = exp2_approx(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
      for (int i = 0; i < TILE / 8; ++i) {
        s[4 * i] = exp2_approx(s[4 * i] - mx_a);
        s[4 * i + 1] = exp2_approx(s[4 * i + 1] - mx_a);
        s[4 * i + 2] = exp2_approx(s[4 * i + 2] - mx_b);
        s[4 * i + 3] = exp2_approx(s[4 * i + 3] - mx_b);
        rs_a += s[4 * i] + s[4 * i + 1];
        rs_b += s[4 * i + 2] + s[4 * i + 3];
      }
      l_a = l_a * alpha_a + rs_a;
      l_b = l_b * alpha_b + rs_b;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc[4 * i] *= alpha_a;
        acc[4 * i + 1] *= alpha_a;
        acc[4 * i + 2] *= alpha_b;
        acc[4 * i + 3] *= alpha_b;
      }
      // P as the A operand of m64nHDk16: k-step kk takes accumulator
      // chunks 2 kk (columns 0-7) and 2 kk + 1 (columns 8-15)
      uint32_t pa[TILE / 16][4];
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V (64 x HD), V MN-major in shared memory
      mbar_wait(v_full + st, ph);
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) fence_regs(pa[kk]);
      wgmma_fence();  // the writes of acc and P above come before the products
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        wgmma_rs<HD>(acc, pa[kk],
                     gmma_desc(v_addr + st * L::BYTES + kk * 16 * L::SW, L::CBLK, 8 * L::SW,
                               L::LAYOUT));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(v_empty + st);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float la = l_a == 0.f ? 1.f : l_a;
    const float lb = l_b == 0.f ? 1.f : l_b;
    __nv_bfloat16* ob = o + b * os.b + h * os.h + col0;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      if (row_a < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_a * os.s + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i] / la, acc[4 * i + 1] / la);
      if (row_b < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_b * os.s + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i + 2] / lb, acc[4 * i + 3] / lb);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA
// ---------------------------------------------------------------------------

namespace f32path {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 8 row groups x 16 column lanes
constexpr int ROWS = 8;       // query rows per thread
constexpr int KCOLS = 4;      // score columns per thread
constexpr int LDT = BQ + 4;   // leading dim of the transposed tiles (= BK + 4)

// Output column of the thread's ci-th accumulator: four contiguous columns
// per 64 when hd is a multiple of 64 (float4 reads of V), else one column
// per 16 lanes.
template <int HD>
__device__ __forceinline__ int out_col(int ci, int tx) {
  if constexpr (HD % 64 == 0) {
    return (ci / 4) * 64 + tx * 4 + (ci % 4);
  } else {
    return ci * 16 + tx;
  }
}

template <int HD>
constexpr int smem_floats() {
  // sQt [HD][LDT] + sKV (K^T [HD][LDT] or V [BK][HD]) + sPt [BK][LDT]
  return HD * LDT + (HD * LDT > BK * HD ? HD * LDT : BK * HD) + BK * LDT;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, int H, int KV, int Sq, int Sk,
           float scale, int causal, Strides qs, Strides ks, Strides vs, Strides os) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int OC = HD / 16;  // output columns per thread
  extern __shared__ float4 smem_raw[];
  float* sQt = reinterpret_cast<float*>(smem_raw);  // [HD][LDT]  q^T * scale
  float* sKV = sQt + HD * LDT;                       // K^T [HD][LDT], then V [BK][HD]
  float* sPt = sKV + (HD * LDT > BK * HD ? HD * LDT : BK * HD);  // [BK][LDT] p^T

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = iq * BQ;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + (h / (H / KV)) * ks.h;
  const float* vb = v + b * vs.b + (h / (H / KV)) * vs.h;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int qi = q0 + r;
    sQt[d * LDT + r] = qi < Sq ? qb[qi * qs.s + d] * scale : 0.f;
  }

  float acc[ROWS][OC];
  float m[ROWS], l[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;  // tiles past it are all masked
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's V and P are consumed
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int c = i / HD, d = i % HD;
      const int kj = k0 + c;
      sKV[d * LDT + c] = kj < Sk ? kb[kj * ks.s + d] : 0.f;
    }
    __syncthreads();

    float s[ROWS][KCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(sQt + d * LDT + ty * ROWS);
      const float4 qc = *reinterpret_cast<const float4*>(sQt + d * LDT + ty * ROWS + 4);
      const float4 kk = *reinterpret_cast<const float4*>(sKV + d * LDT + tx * KCOLS);
      const float qr[ROWS] = {qa.x, qa.y, qa.z, qa.w, qc.x, qc.y, qc.z, qc.w};
      const float kr[KCOLS] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KCOLS; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

    // online softmax over this tile
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q0 + ty * ROWS + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int kj = k0 + tx * KCOLS + j;
        if (kj >= Sk) {
          s[i][j] = -INFINITY;  // not a key: weight 0
        } else if (causal && qi < kj) {
          s[i][j] = NEG_INF;
        }
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < KCOLS; ++j)
#pragma unroll
      for (int i = 0; i < ROWS; ++i) sPt[(tx * KCOLS + j) * LDT + ty * ROWS + i] = s[i][j];
    __syncthreads();  // K^T is consumed, P is written

    for (int i = tid; i < BK * HD; i += THREADS) {
      const int c = i / HD, d = i % HD;
      const int kj = k0 + c;
      sKV[c * HD + d] = kj < Sk ? vb[kj * vs.s + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(sPt + kk * LDT + ty * ROWS);
      const float4 pc = *reinterpret_cast<const float4*>(sPt + kk * LDT + ty * ROWS + 4);
      const float pr[ROWS] = {pa.x, pa.y, pa.z, pa.w, pc.x, pc.y, pc.z, pc.w};
      float vr[OC];
      if constexpr (HD % 64 == 0) {
#pragma unroll
        for (int g = 0; g < OC / 4; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(sKV + kk * HD + g * 64 + tx * 4);
          vr[g * 4 + 0] = vv.x;
          vr[g * 4 + 1] = vv.y;
          vr[g * 4 + 2] = vv.z;
          vr[g * 4 + 3] = vv.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < OC; ++c) vr[c] = sKV[kk * HD + out_col<HD>(c, tx)];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(pr[i], vr[c], acc[i][c]);
    }
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + ty * ROWS + i;
    if (qi >= Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < OC; ++c)
      ob[qi * os.s + out_col<HD>(c, tx)] = acc[i][c] / li;
  }
}

}  // namespace f32path

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-d tensor map over a (B, heads, S, hd) bf16 tensor with the given
// element strides: hd innermost, then the three outer dims in order of
// stride; the box is cb columns x 128 rows of one head.  *perm says which
// coordinate holds seq, head and batch.
CUresult make_map(CUtensorMap* map, Perm* perm, const void* ptr, int B, int heads, int S, int hd,
                  Strides st, int cb, CUtensorMapSwizzle swizzle) {
  struct Dim {
    cuuint64_t size;
    long long stride;
    cuuint32_t box;
    int role;  // 0 seq, 1 head, 2 batch
  } d[3] = {{static_cast<cuuint64_t>(S), st.s, TILE, 0},
            {static_cast<cuuint64_t>(heads), st.h, 1, 1},
            {static_cast<cuuint64_t>(B), st.b, 1, 2}};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim t = d[j];
      d[j] = d[j - 1];
      d[j - 1] = t;
    }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), d[0].size, d[1].size, d[2].size};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d[0].stride) * 2,
                                 static_cast<cuuint64_t>(d[1].stride) * 2,
                                 static_cast<cuuint64_t>(d[2].stride) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cb), d[0].box, d[1].box, d[2].box};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  int slot[3];
  for (int i = 0; i < 3; ++i) slot[d[i].role] = i + 1;
  *perm = Perm{slot[0], slot[1], slot[2]};
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                int Sq, int Sk, float scale, int causal, Strides qs, Strides ks, Strides vs,
                Strides os, cudaStream_t stream) {
  using L = Tile<HD>;
  CUtensorMap mq, mk, mv;
  Perm pq, pk, pv;
  CUresult r = make_map(&mq, &pq, q, B, H, Sq, HD, qs, L::CB, L::TMA_SWIZZLE);
  if (r == CUDA_SUCCESS) r = make_map(&mk, &pk, k, B, KV, Sk, HD, ks, L::CB, L::TMA_SWIZZLE);
  if (r == CUDA_SUCCESS) r = make_map(&mv, &pv, v, B, KV, Sk, HD, vs, L::CB, L::TMA_SWIZZLE);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_bf16<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::SMEM_LAUNCH);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (Sq + TILE - 1) / TILE;
  fa_fwd_bf16<HD><<<nq * H * B, BF16_THREADS, L::SMEM_LAUNCH, stream>>>(
      mq, mk, mv, pq, pk, pv, static_cast<__nv_bfloat16*>(o), os, H, KV, Sq, Sk, scale * LOG2E,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int Sq,
               int Sk, float scale, int causal, Strides qs, Strides ks, Strides vs, Strides os,
               cudaStream_t stream) {
  using namespace f32path;
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_f32<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_f32<HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, KV, Sq, Sk, scale, causal, qs, ks, vs, os);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int H,
                int KV, int Sq, int Sk, float scale, int causal, Strides qs, Strides ks,
                Strides vs, Strides os, cudaStream_t st) {
#define FA_LAUNCH(HD)                                                                     \
  (BF16 ? launch_bf16<HD>(q, k, v, o, B, H, KV, Sq, Sk, scale, causal, qs, ks, vs, os, st) \
        : launch_f32<HD>(q, k, v, o, B, H, KV, Sq, Sk, scale, causal, qs, ks, vs, os, st))
  switch (hd) {
    case 16: return FA_LAUNCH(16);
    case 32: return FA_LAUNCH(32);
    case 64: return FA_LAUNCH(64);
    case 80: return FA_LAUNCH(80);
    case 128: return FA_LAUNCH(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  Strides are in
// elements, (batch, head, seq) for each tensor; head_dim is contiguous.
// For bf16, q, k and v must start on 16 bytes and have strides that are
// multiples of 8 elements (TMA's alignment).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B, int H, int KV,
    int Sq, int Sk, int hd, float scale, int causal,
    long long qsb, long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh, long long oss,
    void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<false>(hd, q, k, v, o, B, H, KV, Sq, Sk, scale, causal, qs, ks, vs, os, st);
  if (dtype == 1)
    return dispatch_hd<true>(hd, q, k, v, o, B, H, KV, Sq, Sk, scale, causal, qs, ks, vs, os, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
