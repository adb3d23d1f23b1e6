// Hand-written Hopper (sm_90a) kernel of the lanes' random draws: the PCG4D
// counter chain of raytracer_odin_tpu_torch/utils/prng.py (uniforms,
// uniforms_cols) in one launch, where the plain chain runs ~105 torch
// kernels a call (multiplies, adds, shifts, masks, xors, the casts and the
// stack). No TPU kernel is replaced: XLA fused the chain for the JAX
// package.
//
// Built with intersect_kernels.cu and shade_kernels.cu into one library by
// raytracer_odin_tpu_torch/ops/cuda_build.py and launched through
// ops/prng_kernel.py.
//
// Same bits as the plain chain, by construction. The plain chain keeps
// each uint32 word in int32 bits; its multiplies and adds wrap, and a
// product or sum of two's-complement words modulo 2^32 has the low 32 bits
// of the exact integer result whatever the words' signedness. Its logical
// shift is the arithmetic shift masked to the shifted-in width, which is
// the uint32 shift; xor is bitwise either way. So the kernel computes the
// chain in native uint32 (wrapping multiply-adds, logical shifts), step for
// step as _pcg4d orders them, and gets the plain chain's words. The unit
// float is (float)(w >> 8) * 2^-24: w >> 8 is below 2^24, so its
// conversion to float and the product by a power of two are exact, as in
// _to_unit. No float is rounded anywhere: the kernel's draws are the
// plain chain's bit for bit, on any device and under any fmad setting.
//
// Bound on the H100: bytes, and before them the launch. A lane reads its
// stream id (4 B; 4 B more for each counter given a lane) and writes its n
// draws (4n B): 28 B at n = 6, so the 2,073,600 lanes of a 1080p frame need
// ~17 us of HBM time; ~40 integer operations a PCG4D block are far below
// the issue rate. The design:
//   * one thread a lane, DRAW_THREADS = 256 a block; the counters go by
//     value where they are one for every lane (a null pointer), so a call
//     of the main path reads only the stream ids;
//   * rows ([lanes, n], draw_stride 1): each thread writes its n draws into
//     a shared-memory tile of the block's [256, n] rows, and the block
//     stores the tile as one contiguous run, each warp 128 B a store;
//   * columns ([n, lanes], draw_stride = lanes): each thread stores draw j
//     at j * draw_stride + lane, already contiguous across a warp;
//   * no atomics: a run is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#define DRAW_THREADS 256
// Draws a lane beyond which rows are stored directly, not through the
// shared tile (the tile is DRAW_THREADS * n floats: 32 KB at this n).
#define DRAW_STAGE_MAX 32

// ops/prng_kernel.py passes these, field for field.
struct DrawArgs {
    const int* samples;   // per-lane sample counters, or null: `sample`
    const int* tags;      // per-lane tag counters, or null: `tag`
    const int* sids;      // per-lane stream ids
    float* out;           // draw j of lane i at i * lane_stride + j * draw_stride
    long long draw_stride;
    int lane_stride;
    int lanes;
    int n;
    uint32_t k0, k1, sample, tag;
};

// PCG4D: ops as utils/prng._pcg4d orders them, in uint32.
__device__ __forceinline__ void pcg4d(uint32_t& a, uint32_t& b, uint32_t& c,
                                      uint32_t& d) {
    a = a * 1664525u + 1013904223u;
    b = b * 1664525u + 1013904223u;
    c = c * 1664525u + 1013904223u;
    d = d * 1664525u + 1013904223u;
    a = a + b * d;
    b = b + c * a;
    c = c + a * b;
    d = d + b * c;
    a = a ^ (a >> 16);
    b = b ^ (b >> 16);
    c = c ^ (c >> 16);
    d = d ^ (d >> 16);
    a = a + b * d;
    b = b + c * a;
    c = c + a * b;
    d = d + b * c;
}

// The top 24 bits as a float in [0, 1) (utils/prng._to_unit), exactly.
__device__ __forceinline__ float to_unit(uint32_t w) {
    return (float)(w >> 8) * (1.0f / 16777216.0f);
}

template <bool STAGED>
__global__ void __launch_bounds__(DRAW_THREADS) draw_kernel(DrawArgs g) {
    extern __shared__ float tile[];
    const int base = blockIdx.x * DRAW_THREADS;
    const int lane = base + threadIdx.x;
    if (lane < g.lanes) {
        const uint32_t s = g.samples ? (uint32_t)__ldg(g.samples + lane)
                                     : g.sample;
        const uint32_t t = g.tags ? (uint32_t)__ldg(g.tags + lane) : g.tag;
        const uint32_t a0 = s ^ g.k0;
        const uint32_t b0 = t ^ g.k1;
        const uint32_t c0 = (uint32_t)__ldg(g.sids + lane);
        for (int blk = 0; 4 * blk < g.n; ++blk) {
            uint32_t w[4] = {a0, b0, c0, (uint32_t)blk};
            pcg4d(w[0], w[1], w[2], w[3]);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int j = 4 * blk + k;
                if (j >= g.n) break;
                if (STAGED) {
                    tile[threadIdx.x * g.n + j] = to_unit(w[k]);
                } else {
                    g.out[(size_t)lane * g.lane_stride
                          + (size_t)j * g.draw_stride] = to_unit(w[k]);
                }
            }
        }
    }
    if (STAGED) {
        // The block's rows are one contiguous run of `count` floats.
        __syncthreads();
        const int count = min(DRAW_THREADS, g.lanes - base) * g.n;
        float* dst = g.out + (size_t)base * g.n;
        for (int i = threadIdx.x; i < count; i += DRAW_THREADS) {
            dst[i] = tile[i];
        }
    }
}

extern "C" {

// The size of the argument struct, which ops/prng_kernel.py checks against
// its ctypes mirror before the first launch.
int rt_draw_abi(int* size) {
    *size = (int)sizeof(DrawArgs);
    return 0;
}

// One launch of the draw kernel over g->lanes lanes on the caller's stream;
// returns cudaGetLastError(). Rows (draw_stride 1, lane_stride n, n up to
// DRAW_STAGE_MAX) go through the shared tile.
int rt_draw_launch(const DrawArgs* g, void* stream) {
    if (g->lanes <= 0 || g->n <= 0) return 0;
    const int blocks = (g->lanes + DRAW_THREADS - 1) / DRAW_THREADS;
    cudaStream_t s = (cudaStream_t)stream;
    if (g->draw_stride == 1 && g->lane_stride == g->n
            && g->n <= DRAW_STAGE_MAX) {
        const size_t smem = (size_t)DRAW_THREADS * g->n * sizeof(float);
        draw_kernel<true><<<blocks, DRAW_THREADS, smem, s>>>(*g);
    } else {
        draw_kernel<false><<<blocks, DRAW_THREADS, 0, s>>>(*g);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
