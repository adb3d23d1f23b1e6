// Hand-written Hopper (sm_90a) kernel of the row layout's shading segment:
// one pass over the lanes computes what ops/integrator.py's segments of
// the row layout (first_segment, later_segment and their halves) compute
// in a chain of torch kernels on the CPU: the env map on a miss, the hit's
// material from its shade row and textures, emission, the 1/3 mixture
// sample, its cosine and VNDF pdfs, the BRDF value, the dense light pdf,
// the continuation rule and the packed lane state. No TPU kernel is
// replaced: XLA fused this chain for the JAX package.
//
// Built with intersect_kernels.cu into one library by
// raytracer_odin_tpu_torch/ops/cuda_build.py, with its flags (-fmad=false,
// IEEE division and square root, no fast math), and launched through
// ops/shade_kernel.py. Each expression is rounded where its torch op rounds
// it, with the libm calls torch's CUDA ops make (sqrtf, sinf, cosf, floorf,
// hypotf, atan2f, asinf), so the kernel and the plain segment agree bit for
// bit on the card. What torch does that C does not say:
//   * a division by a host scalar is a multiplication by its float
//     reciprocal (the `inv_*` arguments, computed on the host as torch
//     computes them);
//   * `1.0 / x` is x.reciprocal(), an IEEE division;
//   * torch.clamp(x, min=) keeps a NaN (fmaxf would drop it): clamp_min;
//   * torch.sum over a short last axis is PyTorch's CUDA reduction
//     (ATen's Reduce.cuh): block_width threads split the axis, each adds
//     its strided share into four accumulators starting from +0, and a warp
//     tree with offsets block_width/2 .. 1 joins them. Three terms are
//     (a + c) + b and four (a + c) + (b + d), each term first added to +0
//     (tsum3, tsum4); the dense light pdf's sum over a chunk of lights
//     follows the same rules for any length (chunk_sum).
//
// Bound on the H100: neither operations nor bytes. A lane of a later
// bounce reads its state (48 B), t, the triangle index, alive and six
// draws (81 B; at bounce 0 the camera ray, t, the index and the draws,
// 56 B) and writes its state and alive (49 B); the split path's HEAD
// writes an 80 B buffer and hit, which TAIL reads with the light pdf
// (85 B) before it writes the state. Its shade row, texels and the light
// table come from L2 (a scene's rows and atlas stay resident there). The
// arithmetic is a few hundred fp32 operations a lane with a dozen libm
// calls, so bounce 0's fused segment of 2 M lanes (105 B a lane) needs
// ~0.065 ms of HBM time and ~0.03 ms of issue
// time; what bounds it is the latency of the dependent chain: each lane's
// shade-row gather feeds the barycentrics, which feed the texture taps,
// which feed the sample, the pdfs and the BRDF. The design hides that
// latency with many lanes in flight and few instructions between loads:
//   * one thread a lane, SHADE_THREADS = 128 a block, so even a 65,536-lane
//     budget gives 512 blocks over 132 SMs; no shared memory and no
//     barrier, so a block retires as soon as its lanes do;
//   * the state as three float4 loads and stores, the draws as three
//     float2, the head buffer of the split path as five float4;
//   * shade rows, texels and light rows through the read-only path
//     (__ldg): a warp's lanes read the same light row at once (a
//     broadcast), and the textures' quad-packed rows give a bilinear tap
//     in four 16-byte loads;
//   * only the sampling strategy a lane draws is computed (torch computes
//     all three and selects), and a normal map only where the triangle has
//     one;
//   * no atomics: a run is deterministic.
// The scene's features are runtime flags (blocks of the row layout absent,
// texture kinds unused, no env map, no lights): they are uniform across a
// launch, so their branches never diverge.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SHADE_THREADS 128
#define RT_RAY_EPS ((float)1e-3)          // ops/geometry.RAY_EPS
#define RT_PI_F ((float)3.141592653589793)
#define RT_TAU_F ((float)6.283185307179586)
#define RT_NORM_EPS ((float)1e-20)        // normalize(eps=1e-20)

// Kernel modes (ops/shade_kernel.py: FUSED, HEAD, TAIL).
#define SHADE_FUSED 0   // head, dense light pdf, tail: state and alive
#define SHADE_HEAD 1    // up to the light pdf: the head buffer and hit
#define SHADE_TAIL 2    // from a given light pdf on: state and alive

// The head buffer of the split path, [n, HEAD_W] f32: pos 0:3, new_d 3:6,
// throughput 6:9, radiance 9:12, value 12:15, p_cos 15, p_vndf 16, 3 pad.
#define HEAD_W 20

// Field for field ops/shade_kernel.py's _Scene (ctypes).
struct ShadeScene {
    const float* shade_row;       // [T, row_width]
    const float* texels;          // [P, 16] quad-packed atlas, linear
    const float* texels_srgb;     // [P, 16] the same, sRGB-decoded
    const int32_t* tex_offset;    // [K]
    const int32_t* tex_width;
    const int32_t* tex_height;
    const float* light_rows;      // [Lpad, 16] p u v ng fac valid pad pad
    int row_width;
    // offsets of the row layout's blocks (scene.row_spec); -1: absent
    int off_ng, off_n, off_tex, off_tan, off_color, off_emission;
    int off_metallic, off_roughness, off_texids;
    int off_tri_p, off_tri_u, off_tri_v;
    // scene.tex_kinds: color, emission, metallic-roughness, normal
    int kind_color, kind_emission, kind_mr, kind_normal;
    int env_tex;                  // -1: none
    int n_lights;                 // the dense light pdf's lights
    int light_chunk;              // lights a step of the dense sum
    int pdf_lanes;                // lanes a step of the dense sum
    // reciprocals torch multiplies with where it divides by a host scalar
    float inv_pi, inv_tau, inv_three, inv_lights;
};

// Field for field ops/shade_kernel.py's _Lanes (ctypes). A vector input
// of the tail is (pointer, row stride in floats), a scalar one (pointer,
// stride): the head's outputs are views of one buffer.
struct ShadeLanes {
    int n;                        // lanes shaded
    int npad;                     // lanes written (first: n up to RB)
    int first;                    // bounce 0: o, d; throughput 1, radiance 0
    int has_p_light;              // tail: p_light given
    const float* o;               // first: [n, 3]
    const float* d;               // first: [n, 3]
    const float* state;           // later: [n, 12]
    const float* t;               // [n]
    const int32_t* tri_idx;       // [n], -1 on a miss
    const uint8_t* alive;         // later: [n]
    const float* uniforms;        // [n, 6]
    const float* pos;             // tail inputs
    const float* new_d;
    const float* p_cos;
    const float* p_vndf;
    const float* value;
    const uint8_t* hit;
    const float* thr;
    const float* rad;
    const float* p_light;
    int pos_s, new_d_s, p_cos_s, p_vndf_s, value_s, hit_s, thr_s, rad_s;
    int p_light_s;
    float* state_out;             // fused, tail: [npad, 12]
    uint8_t* alive_out;           // fused, tail: [npad]
    float* head_out;              // head: [n, HEAD_W]
    uint8_t* hit_out;             // head: [n]
};

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
    V3 r;
    r.x = x;
    r.y = y;
    r.z = z;
    return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
    return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
    return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
    return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
// math3d.cross's component formulas
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x);
}

// A term of torch.sum: the reduction adds it to its +0 start (a -0 term
// becomes +0; no other value changes).
__device__ __forceinline__ float zf(float x) { return 0.0f + x; }
// torch.sum over a last axis of 3 (2 threads: a + c on the first, then b)
// and of 4 (4 threads, offsets 2 then 1).
__device__ __forceinline__ float tsum3(float a, float b, float c) {
    return (zf(a) + zf(c)) + zf(b);
}
__device__ __forceinline__ float tsum4(float a, float b, float c, float d) {
    return (zf(a) + zf(c)) + (zf(b) + zf(d));
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
    return tsum3(a.x * b.x, a.y * b.y, a.z * b.z);
}
// torch.clamp(x, min=lo) and torch.clamp(x, lo, hi): a NaN passes
__device__ __forceinline__ float clamp_min(float x, float lo) {
    return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
// math3d.normalize(x, eps=1e-20)
__device__ __forceinline__ V3 normalize(V3 x) {
    const float n = clamp_min(sqrtf(dot(x, x)), RT_NORM_EPS);
    return v3(x.x / n, x.y / n, x.z / n);
}

// Quaternions (x, y, z, w), math3d's.
struct Q {
    float x, y, z, w;
};
__device__ __forceinline__ Q quat_from_z_to(V3 n) {
    const float w = sqrtf(clamp_min((n.z + 1.0f) * 0.5f, 0.0f));
    const float den = (w > 0.0f ? w : 1.0f) * 2.0f;
    Q q;
    if (w > 0.0f) {
        q.x = (-n.y) / den;
        q.y = n.x / den;
        q.z = 0.0f;
        q.w = w;
    } else {
        q.x = 1.0f;
        q.y = 0.0f;
        q.z = 0.0f;
        q.w = 0.0f;
    }
    return q;
}
__device__ __forceinline__ Q quat_conj(Q q) {
    Q r;
    r.x = -q.x;
    r.y = -q.y;
    r.z = -q.z;
    r.w = q.w;
    return r;
}
// v + 2 * cross(q.xyz, cross(q.xyz, v) + w * v)
__device__ __forceinline__ V3 quat_rotate(Q q, V3 v) {
    const V3 u = v3(q.x, q.y, q.z);
    const V3 t = add(cross(u, v), scale(v, q.w));
    return add(v, scale(cross(u, t), 2.0f));
}

// texture.sample's bilinear tap of atlas entry tid >= 0 at (u, v) from
// `pool` (quad-packed rows p00 p10 p01 p11), with torch.remainder's wrap.
__device__ __forceinline__ int wrap(int a, int b) {
    int r = a % b;
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return r;
}
__device__ __forceinline__ float bilerp(float p00, float p10, float p01,
                                        float p11, float tx, float ty,
                                        float omtx) {
    return (p00 + (p01 - p00) * ty) * omtx + (p10 + (p11 - p10) * ty) * tx;
}
__device__ float4 tex_sample(const ShadeScene& sc, const float* pool,
                             int tid, float u, float v, float4 dflt) {
    if (tid < 0) return dflt;
    const int w = __ldg(sc.tex_width + tid);
    const int h = __ldg(sc.tex_height + tid);
    const int off = __ldg(sc.tex_offset + tid);
    const float px = u * (float)w;
    const float py = v * (float)h;
    const float lx = floorf(px);
    const float ly = floorf(py);
    const float tx = px - lx;
    const float ty = py - ly;
    const int cx = wrap((int)lx, w);
    const int cy = wrap((int)ly, h);
    const float4* q = reinterpret_cast<const float4*>(pool)
                      + (size_t)(int64_t)(off + cy * w + cx) * 4;
    const float4 p00 = __ldg(q);
    const float4 p10 = __ldg(q + 1);
    const float4 p01 = __ldg(q + 2);
    const float4 p11 = __ldg(q + 3);
    const float omtx = 1.0f - tx;
    float4 r;
    r.x = bilerp(p00.x, p10.x, p01.x, p11.x, tx, ty, omtx);
    r.y = bilerp(p00.y, p10.y, p01.y, p11.y, tx, ty, omtx);
    r.z = bilerp(p00.z, p10.z, p01.z, p11.z, tx, ty, omtx);
    r.w = bilerp(p00.w, p10.w, p01.w, p11.w, tx, ty, omtx);
    return r;
}

// shading.light_pdf_terms' contribution of light l to the ray o, d (o
// already offset by RAY_EPS): fac * t^2/|ng.d| where the ray hits it at
// t >= 0, else 0; NaN counts 0, +inf is kept.
__device__ float light_contrib(const ShadeScene& sc, V3 o, V3 d, int l) {
    const float4* r = reinterpret_cast<const float4*>(sc.light_rows)
                      + (size_t)l * 4;
    const float4 a = __ldg(r);       // p.x p.y p.z u.x
    const float4 b = __ldg(r + 1);   // u.y u.z v.x v.y
    const float4 c = __ldg(r + 2);   // v.z ng.x ng.y ng.z
    const float fac = __ldg(reinterpret_cast<const float*>(r + 3));
    const V3 p = v3(a.x, a.y, a.z);
    const V3 u = v3(a.w, b.x, b.y);
    const V3 v = v3(b.z, b.w, c.x);
    const V3 ng = v3(c.y, c.z, c.w);
    const V3 pvec = cross(d, v);
    const float det = dot(u, pvec);
    const float inv = 1.0f / det;
    const V3 tvec = sub(o, p);
    const float bu = dot(tvec, pvec) * inv;
    const V3 qvec = cross(tvec, u);
    const float bv = dot(d, qvec) * inv;
    const float t = dot(v, qvec) * inv;
    const bool ok = (bu >= 0.0f) & (bv >= 0.0f) & (bu + bv <= 1.0f)
                    & (t >= 0.0f);
    const float w = (t * t) / fabsf(dot(ng, d));
    const float contrib = ok ? fac * w : 0.0f;
    return isnan(contrib) ? 0.0f : contrib;
}

// Reduce.cuh's last_pow2: the largest power of two <= n (1 for n < 2).
__device__ __forceinline__ int last_pow2(int n) {
    n |= (n >> 1);
    n |= (n >> 2);
    n |= (n >> 4);
    n |= (n >> 8);
    n |= (n >> 16);
    return max(1, n - (n >> 1));
}

// torch.sum over the last axis of the [lanes, k] contributions of lights
// s .. s + k - 1, for the lane at row `row` of its step of the dense sum,
// in the order of PyTorch's CUDA reduction for a batch of 16 rows or more:
//   * k < 128: block_width = min(last_pow2(k), 32) threads; thread x adds
//     terms x, x + bw, ... (at most four, one an accumulator) to +0 and
//     joins its accumulators in order;
//   * k >= 128 (the vectorised input): bw = min(last_pow2(k / 4), 32);
//     the row's first element sits `shift` floats past a 16-byte boundary
//     (its step's buffer starts on one), so threads shift..3 first take the
//     head up to that boundary, then thread x adds 16-byte groups x, x + bw,
//     ... into its four accumulators and one tail term;
// then the warp tree joins thread x with thread x + offset for offsets
// bw/2 .. 1. That tree is the pairwise sum of the threads' partials in
// bit-reversed order, which a stack of one partial a level computes as the
// partials arrive: lvl[l] holds a finished subtree of 2^l partials.
__device__ float chunk_sum(const ShadeScene& sc, V3 o, V3 d, int s, int k,
                           int row) {
    const bool vec = k >= 128;
    const int bw = min(last_pow2(vec ? k / 4 : k), 32);
    const int m = __ffs(bw) - 1;
    const int shift = vec ? (int)(((int64_t)row * k) & 3) : 0;
    float lvl[6];
    float total = 0.0f;
    for (int j = 0; j < bw; ++j) {
        const int tx = m ? (int)(__brev((unsigned)j) >> (32 - m)) : 0;
        float part;
        if (!vec) {
            float acc[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int e = tx + q * bw;
                acc[q] = e < k ? zf(light_contrib(sc, o, d, s + e)) : 0.0f;
            }
            part = ((acc[0] + acc[1]) + acc[2]) + acc[3];
        } else {
            int end = k;
            int b = 0;
            float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
            if (shift > 0) {
                if (tx >= shift && tx < 4) {
                    a0 = zf(light_contrib(sc, o, d, s + tx - shift));
                }
                end = k + shift - 4;
                b = 4 - shift;
            }
            for (int idx = tx; idx * 4 + 3 < end; idx += bw) {
                const int e = s + b + idx * 4;
                a0 = a0 + light_contrib(sc, o, d, e);
                a1 = a1 + light_contrib(sc, o, d, e + 1);
                a2 = a2 + light_contrib(sc, o, d, e + 2);
                a3 = a3 + light_contrib(sc, o, d, e + 3);
            }
            const int tail = end - end % 4 + tx;
            if (tail < end) a0 = a0 + light_contrib(sc, o, d, s + b + tail);
            part = ((a0 + a1) + a2) + a3;
        }
        int jj = j;
        bool placed = false;
#pragma unroll
        for (int l = 0; l < 6; ++l) {
            if (!placed) {
                if (jj & 1) {
                    part = lvl[l] + part;
                } else {
                    lvl[l] = part;
                    placed = true;
                }
                jj >>= 1;
            }
        }
        total = part;  // the last partial closes every level: the sum
    }
    return total;
}

// shading.light_pdf_sum of one lane (the dense sum): chunk sums joined as
// acc + chunk from +0, divided by the light count.
__device__ float dense_light_pdf(const ShadeScene& sc, V3 pos, V3 dir,
                                 int lane) {
    const V3 o = add(pos, scale(dir, RT_RAY_EPS));
    const int row = lane % sc.pdf_lanes;
    float acc = 0.0f;
    for (int s = 0; s < sc.n_lights; s += sc.light_chunk) {
        const int k = min(sc.light_chunk, sc.n_lights - s);
        acc = acc + chunk_sum(sc, o, dir, s, k, row);
    }
    return acc * sc.inv_lights;
}

struct Head {
    V3 pos, new_d, value, thr, rad;
    float p_cos, p_vndf;
    bool hit;
};

// integrator._shade_head and eval_head of one lane: the env term on a
// miss, the material (_point_material), the mixture sample
// (shading.sample_direction), its cosine and VNDF pdfs (bsdf_pdfs), the
// BRDF value (shading.shade) and the emission on a hit.
__device__ __forceinline__ Head shade_head(const ShadeScene& sc, V3 o, V3 d,
                                           float t, int tri, bool alive,
                                           const float* u, V3 thr, V3 rad) {
    Head h;
    const bool valid = tri >= 0;
    h.hit = valid && alive;
    const bool missed = !valid && alive;
    if (sc.env_tex >= 0) {
        const float eu = atan2f(d.z, d.x) * sc.inv_tau + 0.5f;
        const float ev = 0.5f - asinf(clamp2(d.y, -1.0f, 1.0f)) * sc.inv_pi;
        const float4 e = tex_sample(sc, sc.texels, sc.env_tex, eu, ev,
                                    make_float4(0.f, 0.f, 0.f, 0.f));
        rad.x = rad.x + (missed ? thr.x * e.x : 0.0f);
        rad.y = rad.y + (missed ? thr.y * e.y : 0.0f);
        rad.z = rad.z + (missed ? thr.z * e.z : 0.0f);
    }

    // The material: barycentrics recomputed from the shade row's triangle
    // (a miss reads triangle 0's row, as the plain version does).
    const float* row = sc.shade_row + (size_t)max(tri, 0) * sc.row_width;
#define R(off) __ldg(row + (off))
#define R3(off) v3(R(off), R((off) + 1), R((off) + 2))
    const V3 oo = add(o, scale(d, RT_RAY_EPS));
    const V3 tu = R3(sc.off_tri_u);
    const V3 tv3 = R3(sc.off_tri_v);
    const V3 pv = cross(d, tv3);
    const float det = dot(tu, pv);
    const float inv = det != 0.0f ? 1.0f / det : 0.0f;
    const V3 tvec = sub(oo, R3(sc.off_tri_p));
    const float bu = dot(tvec, pv) * inv;
    const V3 qv = cross(tvec, tu);
    const float bv = dot(d, qv) * inv;
    const float w0 = (1.0f - bu) - bv;
    const float w1 = bu;
    const float w2 = bv;
    h.pos = add(o, scale(d, t));

    float tcu = 0.0f, tcv = 0.0f;
    int m_color = -1, m_emission = -1, m_mr = -1, m_normal = -1;
    if (sc.off_texids >= 0) {
        const int ot = sc.off_tex;
        tcu = (R(ot) * w0 + R(ot + 2) * w1) + R(ot + 4) * w2;
        tcv = (R(ot + 1) * w0 + R(ot + 3) * w1) + R(ot + 5) * w2;
        m_color = (int)R(sc.off_texids);
        m_emission = (int)R(sc.off_texids + 1);
        m_mr = (int)R(sc.off_texids + 2);
        m_normal = (int)R(sc.off_texids + 3);
    }
    const float4 one = make_float4(1.f, 1.f, 1.f, 1.f);
    const float4 mr = sc.kind_mr
        ? tex_sample(sc, sc.texels, m_mr, tcu, tcv, one) : one;
    const float4 col_t = sc.kind_color
        ? tex_sample(sc, sc.texels_srgb, m_color, tcu, tcv, one) : one;
    const float4 emi_t = sc.kind_emission
        ? tex_sample(sc, sc.texels_srgb, m_emission, tcu, tcv, one) : one;

    const int on = sc.off_n;
    const V3 n_interp = v3(
        (R(on) * w0 + R(on + 3) * w1) + R(on + 6) * w2,
        (R(on + 1) * w0 + R(on + 4) * w1) + R(on + 7) * w2,
        (R(on + 2) * w0 + R(on + 5) * w1) + R(on + 8) * w2);
    const V3 n_smooth = normalize(n_interp);
    V3 normal = n_smooth;
    if (sc.kind_normal && m_normal >= 0) {
        // normal mapping: the tangent4 normalised as a 4-vector
        const int oa = sc.off_tan;
        float tn[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            tn[c] = (R(oa + c) * w0 + R(oa + 4 + c) * w1)
                    + R(oa + 8 + c) * w2;
        }
        const float len = clamp_min(
            sqrtf(tsum4(tn[0] * tn[0], tn[1] * tn[1], tn[2] * tn[2],
                        tn[3] * tn[3])),
            RT_NORM_EPS);
#pragma unroll
        for (int c = 0; c < 4; ++c) tn[c] = tn[c] / len;
        const V3 lx = v3(tn[0], tn[1], tn[2]);
        const V3 ly = scale(cross(n_smooth, lx), tn[3]);
        const float4 ns = tex_sample(sc, sc.texels, m_normal, tcu, tcv,
                                     make_float4(0.5f, 1.f, 0.5f, 0.f));
        const float ln0 = ns.x * 2.0f - 1.0f;
        const float ln1 = ns.y * 2.0f - 1.0f;
        const float ln2 = ns.z * 2.0f - 1.0f;
        normal = normalize(add(add(scale(lx, ln0), scale(ly, ln1)),
                               scale(n_smooth, ln2)));
    }
    if (dot(R3(sc.off_ng), d) > 0.0f) normal = neg(normal);  // inside
    const int oc = sc.off_color;
    const int oe = sc.off_emission;
    const V3 color = v3(R(oc) * col_t.x, R(oc + 1) * col_t.y,
                        R(oc + 2) * col_t.z);
    const V3 emission = v3(R(oe) * emi_t.x, R(oe + 1) * emi_t.y,
                           R(oe + 2) * emi_t.z);
    const float rough = clamp_min(R(sc.off_roughness) * mr.y, (float)0.03);
    const float metal = R(sc.off_metallic) * mr.z;
#undef R
#undef R3

    // The mixture sample: only the strategy the lane draws.
    const Q rot = quat_from_z_to(normal);
    const V3 omega = neg(d);
    const V3 vr = quat_rotate(quat_conj(rot), omega);
    const float alpha = rough * rough;
    const float s0 = u[0];
    const bool use_cos = s0 <= (float)0.33333;
    const bool use_light = !use_cos && s0 < (float)0.666666
                           && sc.n_lights > 0;
    V3 nd;
    if (use_cos) {
        const float phi = RT_TAU_F * u[1];
        const float z = u[2] * 2.0f - 1.0f;
        const float r = sqrtf(clamp_min(1.0f - z * z, 0.0f));
        nd = normalize(add(v3(sinf(phi) * r, cosf(phi) * r, z), normal));
    } else if (use_light) {
        const int nl = sc.n_lights;
        const int idx = min((int)(u[3] * (float)nl), nl - 1);
        const bool flip = u[4] + u[5] > 1.0f;
        const float su = flip ? 1.0f - u[4] : u[4];
        const float sv = flip ? 1.0f - u[5] : u[5];
        const float4* lr = reinterpret_cast<const float4*>(sc.light_rows)
                           + (size_t)idx * 4;
        const float4 a = __ldg(lr);
        const float4 b = __ldg(lr + 1);
        const float4 c = __ldg(lr + 2);
        const V3 world = add(add(v3(a.x, a.y, a.z),
                                 scale(v3(a.w, b.x, b.y), su)),
                             scale(v3(b.z, b.w, c.x), sv));
        nd = normalize(sub(world, h.pos));
    } else {
        // Heitz's VNDF sample of the GGX half-vector, reflected
        const V3 vh = normalize(v3(alpha * vr.x, alpha * vr.y, vr.z));
        const float lensq = hypotf(vh.x, vh.y);
        const float sl = lensq == 0.0f ? 1.0f : lensq;
        const V3 t1v = lensq == 0.0f ? v3(1.0f, 0.0f, 0.0f)
                                     : v3((-vh.y) / sl, vh.x / sl, 0.0f);
        const V3 t2v = cross(vh, t1v);
        const float r = sqrtf(u[4]);
        const float phi = RT_TAU_F * u[5];
        const float t1 = r * sinf(phi);
        float t2 = r * cosf(phi);
        const float s = (vh.z + 1.0f) * 0.5f;
        const float t1sq = t1 * t1;
        t2 = (1.0f - s) * sqrtf(clamp_min(1.0f - t1sq, 0.0f)) + s * t2;
        const float up = sqrtf(clamp_min((1.0f - t1sq) - t2 * t2, 0.0f));
        const V3 nh = v3((t1 * t1v.x + t2 * t2v.x) + up * vh.x,
                         (t1 * t1v.y + t2 * t2v.y) + up * vh.y,
                         (t1 * t1v.z + t2 * t2v.z) + up * vh.z);
        const V3 ne = normalize(v3(alpha * nh.x, alpha * nh.y,
                                   clamp_min(nh.z, 0.0f)));
        const V3 hv = quat_rotate(rot, ne);
        const float k2 = dot(hv, d) * 2.0f;
        nd = sub(d, scale(hv, k2));
    }
    h.new_d = nd;

    // The pdfs that read no light (bsdf_pdfs) and the BRDF (shade): the
    // half-vector of shade is vndf_pdf's Ne (the same sum of the same
    // terms), and cos(theta) is the cosine pdf's dot.
    const float cosine = dot(nd, normal);
    h.p_cos = clamp_min(cosine * sc.inv_pi, 0.0f);
    const V3 hh = normalize(add(omega, nd));
    const V3 nr = quat_rotate(quat_conj(rot), hh);
    const float alpha2 = alpha * alpha;
    const float lam = (sqrtf((alpha2 * (vr.x * vr.x + vr.y * vr.y))
                             / (vr.z * vr.z) + 1.0f) + -1.0f) * 0.5f;
    const float g1 = 1.0f / (lam + 1.0f);
    const float nx = nr.x / alpha;
    const float ny = nr.y / alpha;
    const float inner = (nx * nx + ny * ny) + nr.z * nr.z;
    const float dd = 1.0f / ((alpha2 * RT_PI_F) * (inner * inner));
    const float vn = ((g1 * clamp_min(dot(vr, nr), 0.0f)) * dd) / vr.z;
    h.p_vndf = vn / (dot(nd, hh) * 4.0f);

    const float fb = 1.0f - dot(hh, nd);
    const float fb5 = (((fb * fb) * fb) * fb) * fb;
    const float fds = fb5 * (float)(1.0 - 0.04) + (float)0.04;
    const float hn = dot(hh, normal);
    const float qd = (alpha2 - 1.0f) * (hn * hn) + 1.0f;
    const float dist = (alpha2 * (hn >= 0.0f ? 1.0f : 0.0f))
                       / ((qd * qd) * RT_PI_F);
    const float cv = dot(normal, omega);
    const float g_l = (clamp_min(cosine, 0.0f) * 2.0f)
        / (cosine + sqrtf(alpha2 + (1.0f - alpha2) * (cosine * cosine)));
    const float g_v = (clamp_min(cv, 0.0f) * 2.0f)
        / (cv + sqrtf(alpha2 + (1.0f - alpha2) * (cv * cv)));
    const float spec = (dist * (g_l * g_v)) / (cv * 4.0f);
    const float cpos = clamp_min(cosine, 0.0f);
    const float cs[3] = {color.x, color.y, color.z};
    float val[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float fm = cs[c] + (1.0f - cs[c]) * fb5;
        const float diffuse = (cs[c] * cpos) * sc.inv_pi;
        const float dielectric = diffuse + (spec - diffuse) * fds;
        val[c] = dielectric + (spec * fm - dielectric) * metal;
    }
    h.value = v3(val[0], val[1], val[2]);

    h.rad = v3(rad.x + (h.hit ? thr.x * emission.x : 0.0f),
               rad.y + (h.hit ? thr.y * emission.y : 0.0f),
               rad.z + (h.hit ? thr.z * emission.z : 0.0f));
    h.thr = thr;
    return h;
}

// integrator._segment_tail of one lane: the mixture pdf, the continuation
// rule (NaN compares false) and the throughput update.
__device__ __forceinline__ void shade_tail(const Head& h, bool has_p_light,
                                           float p_light, float inv_three,
                                           V3* thr, bool* cont) {
    const float pdf = has_p_light
        ? ((h.p_cos + p_light) + h.p_vndf) * inv_three
        : (h.p_cos + h.p_vndf * 2.0f) * inv_three;
    const V3 v = h.value;
    const float l1 = tsum3(fabsf(v.x), fabsf(v.y), fabsf(v.z));
    *cont = (l1 / pdf > (float)1e-5) && h.hit;
    *thr = *cont ? v3(h.thr.x * (v.x / pdf), h.thr.y * (v.y / pdf),
                      h.thr.z * (v.z / pdf))
                 : h.thr;
}

__device__ __forceinline__ void store_state(const ShadeLanes& ln, int i,
                                            V3 pos, V3 nd, V3 thr, V3 rad,
                                            bool alive) {
    float4* s = reinterpret_cast<float4*>(ln.state_out) + (size_t)i * 3;
    s[0] = make_float4(pos.x, pos.y, pos.z, nd.x);
    s[1] = make_float4(nd.y, nd.z, thr.x, thr.y);
    s[2] = make_float4(thr.z, rad.x, rad.y, rad.z);
    ln.alive_out[i] = alive ? 1 : 0;
}

template <int MODE>
__global__ void __launch_bounds__(SHADE_THREADS)
shade_kernel(const ShadeScene sc, const ShadeLanes ln) {
    const int i = blockIdx.x * SHADE_THREADS + threadIdx.x;
    if (i >= ln.npad) return;
    if (i >= ln.n) {  // bounce 0's padding lanes: zero and dead
        if (MODE == SHADE_HEAD) return;
        const V3 z = v3(0.0f, 0.0f, 0.0f);
        store_state(ln, i, z, z, z, z, false);
        return;
    }
    Head h;
    if (MODE == SHADE_TAIL) {
        const float* p = ln.pos + (size_t)i * ln.pos_s;
        const float* nd = ln.new_d + (size_t)i * ln.new_d_s;
        const float* va = ln.value + (size_t)i * ln.value_s;
        const float* th = ln.thr + (size_t)i * ln.thr_s;
        const float* ra = ln.rad + (size_t)i * ln.rad_s;
        h.pos = v3(p[0], p[1], p[2]);
        h.new_d = v3(nd[0], nd[1], nd[2]);
        h.value = v3(va[0], va[1], va[2]);
        h.thr = v3(th[0], th[1], th[2]);
        h.rad = v3(ra[0], ra[1], ra[2]);
        h.p_cos = ln.p_cos[(size_t)i * ln.p_cos_s];
        h.p_vndf = ln.p_vndf[(size_t)i * ln.p_vndf_s];
        h.hit = ln.hit[(size_t)i * ln.hit_s] != 0;
    } else {
        V3 o, d, thr, rad;
        bool alive;
        if (ln.first) {
            const float* po = ln.o + (size_t)i * 3;
            const float* pd = ln.d + (size_t)i * 3;
            o = v3(po[0], po[1], po[2]);
            d = v3(pd[0], pd[1], pd[2]);
            thr = v3(1.0f, 1.0f, 1.0f);
            rad = v3(0.0f, 0.0f, 0.0f);
            alive = true;
        } else {
            const float4* s = reinterpret_cast<const float4*>(ln.state)
                              + (size_t)i * 3;
            const float4 a = s[0], b = s[1], c = s[2];
            o = v3(a.x, a.y, a.z);
            d = v3(a.w, b.x, b.y);
            thr = v3(b.z, b.w, c.x);
            rad = v3(c.y, c.z, c.w);
            alive = ln.alive[i] != 0;
        }
        const float2* pu = reinterpret_cast<const float2*>(ln.uniforms)
                           + (size_t)i * 3;
        const float2 ua = pu[0], ub = pu[1], uc = pu[2];
        const float u[6] = {ua.x, ua.y, ub.x, ub.y, uc.x, uc.y};
        h = shade_head(sc, o, d, ln.t[i], ln.tri_idx[i], alive, u, thr, rad);
        if (MODE == SHADE_HEAD) {
            float4* q = reinterpret_cast<float4*>(ln.head_out)
                        + (size_t)i * (HEAD_W / 4);
            q[0] = make_float4(h.pos.x, h.pos.y, h.pos.z, h.new_d.x);
            q[1] = make_float4(h.new_d.y, h.new_d.z, h.thr.x, h.thr.y);
            q[2] = make_float4(h.thr.z, h.rad.x, h.rad.y, h.rad.z);
            q[3] = make_float4(h.value.x, h.value.y, h.value.z, h.p_cos);
            q[4] = make_float4(h.p_vndf, 0.0f, 0.0f, 0.0f);
            ln.hit_out[i] = h.hit ? 1 : 0;
            return;
        }
    }
    bool has_p_light;
    float p_light = 0.0f;
    if (MODE == SHADE_TAIL) {
        has_p_light = ln.has_p_light != 0;
        if (has_p_light) p_light = ln.p_light[(size_t)i * ln.p_light_s];
    } else {
        has_p_light = sc.n_lights > 0;
        if (has_p_light) p_light = dense_light_pdf(sc, h.pos, h.new_d, i);
    }
    V3 thr;
    bool cont;
    shade_tail(h, has_p_light, p_light, sc.inv_three, &thr, &cont);
    store_state(ln, i, h.pos, h.new_d, thr, h.rad, cont);
}

extern "C" {

// The sizes of the two argument structs, which ops/shade_kernel.py checks
// against its ctypes mirrors before the first launch.
int rt_shade_abi(int* sizes) {
    sizes[0] = (int)sizeof(ShadeScene);
    sizes[1] = (int)sizeof(ShadeLanes);
    return 0;
}

// One launch of the shade kernel in `mode` over ln->npad lanes on the
// caller's stream; returns cudaGetLastError().
int rt_shade_launch(int mode, const ShadeScene* sc, const ShadeLanes* ln,
                    void* stream) {
    if (ln->npad <= 0) return 0;
    const int blocks = (ln->npad + SHADE_THREADS - 1) / SHADE_THREADS;
    cudaStream_t s = (cudaStream_t)stream;
    if (mode == SHADE_FUSED) {
        shade_kernel<SHADE_FUSED><<<blocks, SHADE_THREADS, 0, s>>>(*sc, *ln);
    } else if (mode == SHADE_HEAD) {
        shade_kernel<SHADE_HEAD><<<blocks, SHADE_THREADS, 0, s>>>(*sc, *ln);
    } else {
        shade_kernel<SHADE_TAIL><<<blocks, SHADE_THREADS, 0, s>>>(*sc, *ln);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
