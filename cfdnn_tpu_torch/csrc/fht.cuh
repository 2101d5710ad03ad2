// fht_pass and fht_modal: the four-step real Hartley transform of the
// "pallas_fft" Poisson solve, along one axis of a contiguous (X, Y, Z)
// array. The kernel template; its C entry points are fht.cu (float32
// passes and the split check), fht_modal.cu, fht_f64.cu and
// fht_modal_f64.cu, one source each so that they compile in parallel.
//
// Replaces cfdnn_tpu/poisson/pallas_fht.py fht_pallas (body _kernel) and
// fht_pallas_modal (body _kernel_modal). The plain PyTorch twins are
// poisson/pallas_fht.py fht_pass_twin and fht_modal_twin; the wrappers are
// ops/kernels.py fht_pass and fht_modal.
//
// Math, along a line of N = N1*N2 points (n = n1*N2 + n2, N1 <= 8):
//   forward  tt[k1] = sum_n1 H1[k1][n1] x[n1], tf = tt[(N1 - k1) % N1],
//            u_c = c tt + s tf, u_s = c tf - s tt   ((c, s) at k1*n2 of N),
//            X[k1*N2 + k2] = sum_n2 C2[k2 n2] u_c[n2] + S2[k2 n2] u_s[n2]
//                          = Re DFT_N2(u_c + i u_s)[k2]   (sign e^{-i theta})
//            (digit-permuted: X[k1*N2 + k2] holds wavenumber k1 + N1*k2);
//   inverse  the unnormalized adjoint: v_c + i v_s = sum_k2 X[k2]
//            e^{+2 pi i k2 n2 / N2}, a1 = c v_c - s v_s, a2 = s v_c + c v_s,
//            x[n1] = sum_k H1[n1][k] a1[k] + H1[(N1 - k) % N1][n1] a2[k];
//   modal    forward, each mode times norm / (lam_axis[p] + lam_rest[line])
//            (0 where |lam_axis + lam_rest| < thr), then the inverse.
//
// The N2 stage is a mixed-radix FFT, N2 = r * 2^m (r in {1, 3, 5, 7},
// m >= 3): in-place decimation in frequency over the stages R_1 ... R_s
// (the power of two as radix-16 butterflies but the first, which takes
// the rest of the bits, then the odd factor; each butterfly a small DFT
// in registers), so natural order in and the digit-reversed order out:
// position k_1 L_1 + k_2 L_2 + ... (L_i = N2 / (R_1 ... R_i)) holds
// frequency k_1 + R_1 k_2 + R_1 R_2 k_3 + ... The inverse runs the
// adjoint of each stage in the reverse order, so it takes the
// digit-reversed order in and gives the natural order out: the modal
// pass's forward and inverse meet in the digit-reversed order, and its
// last forward stage, the 1/lambda scale and the first inverse stage are
// one butterfly in registers. Every twiddle, of the stages and inside the
// odd-radix DFTs, is an entry of the N2-entry table (cos, sin)(2 pi m /
// N2); the N1 twiddles are the N-entry table's, read through L1. (The
// table's flipped H1 is not read: tf is a permutation of tt.)
//
// Bound on the H100: bytes. The function needs ~2.5 log2 N flops a point
// a direction, 8 bytes a point moved in float32: 0.32 ms a pass at 512^3
// from the card's 3.35 TB/s, ~0.1 ms from its 67 TFLOP/s. What holds the
// kernel is how many of its loads are in flight and its passes over
// shared memory, not the flops: a pass runs the cas stage and two FFT
// stages (N2 = 128 as radix 8 then 16), each a read and a write of the
// tile, the modal pass four. Design against that: a block takes W = 16
// lines (W consecutive z columns along x or y, so each warp access covers
// W consecutive floats of a row; W consecutive rows along z), 256
// threads, the lines in shared memory as N complex values each, one pad
// slot after every 16 and one a line against bank conflicts (71 KB at N
// = 512 float32: three blocks an SM). One read and one write of the field
// a pass, also for the modal pass: the cas stage reads device memory, a
// thread's loads of 16 / N1 items issued before it uses the first, and
// the last stage writes it (the inverse: the last stage reads X, the cas
// stage writes x). The cas stage is compiled for each N1 (a switch), the
// stages for N2 = 128 (the solver's split at 128 k points); with radix 16
// last every stage's slots there are constant offsets. W halves where a
// block would pass 112 KB.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN1 = 8;
constexpr int kThreads = 256;
constexpr int kMaxLines = 16;
constexpr int kMaxStages = 4;     // at most three powers of two and r
constexpr int kMaxN2 = 4096;
// dynamic shared memory: the opt-in limit of a block (227 KB) less the
// static arrays, and the size below which two blocks share an SM
constexpr size_t kMaxSmem = 227 * 1024 - 1024;
constexpr size_t kTargetSmem = 112 * 1024;

enum Mode { kForward = 0, kInverse = 1, kModal = 2 };

// How a stage reads and writes: the general stage (any M, twiddles), or
// one of the last stage's forms (M = R, no twiddle): the forward's real
// output, the inverse's real input, and the modal pass's turn (the
// forward stage, the scale and the adjoint stage in registers).
enum Io { kFwd = 0, kAdj = 1, kFwdRealOut = 2, kAdjRealIn = 3, kTurn = 4 };

struct Plan {
    int ns;                       // stages
    int radix[kMaxStages];        // R_1 ... R_s
};

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// The plan of N2 = r * 2^m (r in {1, 3, 5, 7}, m >= 3): the power of two
// as ceil(m / 4) stages, radix 16 but the first, which takes the rest of
// the bits, then r. With 16 last each power-of-two stage's stride L is a
// multiple of 16 (the tile's padding period) or 1 at a 16-aligned
// position, so its slots are constant offsets from its first.
__host__ __device__ constexpr int pow2_bits(int n) {
    return n % 2 ? 0 : 1 + pow2_bits(n / 2);
}
__host__ __device__ constexpr int n_pow2_stages(int n2) {
    return (pow2_bits(n2) + 3) / 4;
}
__host__ __device__ constexpr int n_stages(int n2) {
    return n_pow2_stages(n2) + ((n2 >> pow2_bits(n2)) > 1 ? 1 : 0);
}
__host__ __device__ constexpr int radix_at(int n2, int i) {
    return i >= n_pow2_stages(n2) ? n2 >> pow2_bits(n2)
        : i > 0 ? 16 : 1 << (pow2_bits(n2) - 4 * (n_pow2_stages(n2) - 1));
}

// False where N2 has no such form.
bool plan_radices(int n2, Plan& p) {
    if (n2 < 8 || n2 > kMaxN2) return false;
    const int r = n2 >> pow2_bits(n2);
    if (pow2_bits(n2) < 3 || !(r == 1 || r == 3 || r == 5 || r == 7))
        return false;
    p.ns = n_stages(n2);
    for (int i = 0; i < p.ns; ++i) p.radix[i] = radix_at(n2, i);
    return true;
}

// complex slots a line: N values, one pad slot after every 16, and one
// more so that consecutive lines start in different banks
__host__ __device__ inline int line_slots(int n) { return n + (n >> 4) + 1; }

// the block's tables (the N2 entries, H1), its lines and k2_of
size_t smem_bytes(int n1, int n2, int lines, size_t esz) {
    const size_t tile = static_cast<size_t>(lines) * line_slots(n1 * n2);
    return esz * (2 * static_cast<size_t>(n2) + kMaxN1 * kMaxN1 + 2 * tile)
        + sizeof(int) * static_cast<size_t>(n2);
}

// Lines a block (W): the largest of 16, 8, 4, 2, 1 whose block fits
// kTargetSmem (else the largest that fits kMaxSmem); 0 where none does or
// the split is not one the kernel takes.
int plan_tile(int n1, int n2, size_t esz) {
    Plan p;
    if (n1 < 1 || n1 > kMaxN1 || !plan_radices(n2, p)) return 0;
    const size_t caps[2] = {kTargetSmem, kMaxSmem};
    for (size_t cap : caps)
        for (int w = kMaxLines; w >= 1; w /= 2)
            if (smem_bytes(n1, n2, w, esz) <= cap) return w;
    return 0;
}

// ---- complex arithmetic in registers ------------------------------------

template <typename V>
__device__ __forceinline__ V cadd(V a, V b) { return {a.x + b.x, a.y + b.y}; }
template <typename V>
__device__ __forceinline__ V csub(V a, V b) { return {a.x - b.x, a.y - b.y}; }
template <typename V>
__device__ __forceinline__ V cconj(V a) { return {a.x, -a.y}; }

// a * e^{-i theta} with (c, s) = (cos, sin) theta
template <typename V, typename T>
__device__ __forceinline__ V rot(V a, T c, T s) {
    return {fma(a.x, c, a.y * s), fma(a.y, c, -(a.x * s))};
}

// cos and sin of 2 pi m / 16
template <typename T>
__device__ __forceinline__ T cos16(int m) {
    switch (m & 15) {
        case 0: return T(1);
        case 1: case 15: return T(0.92387953251128675613);
        case 2: case 14: return T(0.70710678118654752440);
        case 3: case 13: return T(0.38268343236508977173);
        case 4: case 12: return T(0);
        case 5: case 11: return T(-0.38268343236508977173);
        case 6: case 10: return T(-0.70710678118654752440);
        case 7: case 9: return T(-0.92387953251128675613);
        default: return T(-1);
    }
}
template <typename T>
__device__ __forceinline__ T sin16(int m) { return cos16<T>(m - 4); }

// a * e^{-2 pi i m / 16}; m is a constant after unrolling, and the
// multiples of a quarter turn take no multiply
template <typename T, typename V>
__device__ __forceinline__ V rot16(V a, int m) {
    switch (m & 15) {
        case 0: return a;
        case 4: return {a.y, -a.x};
        case 8: return {-a.x, -a.y};
        case 12: return {-a.y, a.x};
        default: return rot(a, cos16<T>(m), sin16<T>(m));
    }
}

// y_k = sum_l a_l e^{-2 pi i l k / R} in place, R a power of two <= 16:
// radix-2 decimation in frequency in registers, then the bit reversal as
// a renaming. (Every loop counts up by one, so that it unrolls and each
// index is a constant: a[] stays in registers.)
template <int R, typename T, typename V>
__device__ __forceinline__ void dft_pow2(V* a) {
    constexpr int kLog = pow2_bits(R);
#pragma unroll
    for (int lv = 0; lv < kLog; ++lv) {
        const int h = R >> (lv + 1);
#pragma unroll
        for (int i = 0; i < R / 2; ++i) {
            const int j = i % h, lo = (i / h) * 2 * h + j;
            const V u = a[lo], v = a[lo + h];
            a[lo] = cadd(u, v);
            a[lo + h] = rot16<T>(csub(u, v), j * (8 / h));
        }
    }
    V y[R];
#pragma unroll
    for (int p = 0; p < R; ++p) {
        int q = 0;
#pragma unroll
        for (int i = 0; i < kLog; ++i) q = 2 * q + ((p >> i) & 1);
        y[q] = a[p];
    }
#pragma unroll
    for (int p = 0; p < R; ++p) a[p] = y[p];
}

// The same for R = 3, 5 or 7, dense over the conjugate pairs; c[m], s[m]
// = (cos, sin)(2 pi m / R).
template <int R, typename T, typename V>
__device__ __forceinline__ void dft_odd(V* a, const T* c, const T* s) {
    V y[R];
    y[0] = a[0];
#pragma unroll
    for (int l = 1; l < R; ++l) y[0] = cadd(y[0], a[l]);
#pragma unroll
    for (int k = 1; k < R; ++k) {
        V acc = a[0];
#pragma unroll
        for (int l = 1; 2 * l < R; ++l) {
            const int m = (l * k) % R;
            const V p = cadd(a[l], a[R - l]), d = csub(a[l], a[R - l]);
            acc.x = fma(p.x, c[m], fma(d.y, s[m], acc.x));
            acc.y = fma(p.y, c[m], -fma(d.x, s[m], -acc.y));
        }
        y[k] = acc;
    }
#pragma unroll
    for (int k = 0; k < R; ++k) a[k] = y[k];
}

template <int R, typename T, typename V>
__device__ __forceinline__ void dft(V* a, const T* c, const T* s) {
    if constexpr ((R & (R - 1)) == 0) dft_pow2<R, T>(a);
    else dft_odd<R, T>(a, c, s);
}

// The shared tile: line w's complex slot q
__device__ __forceinline__ int slot(int w, int q, int ls) {
    return w * ls + q + (q >> 4);
}

// Everything a stage reads besides the tile.
template <typename T>
struct Tile {
    using V2 = typename Vec2<T>::type;
    V2* z;                    // (W, ls) complex slots
    const V2* tab2;           // (cos, sin)(2 pi m / N2), m < N2
    const int* k2_of;         // frequency at each position of a group
    const long long* base;    // the block's lines' first points
    const T* lr;              // modal: lam_rest of the block's lines
    const T* in;              // the inverse: X
    T* out;                   // the forward: X
    const T* lam_axis;        // modal: (N,) digit-permuted
    long long inner, nlines, l0;
    int n1, n2, lw, ls, tid, nt;   // lw: log2 W
    T thr, norm;
};

// One in-place stage of radix R on every (line, k1) group: sub-length M,
// L = M / R; butterfly (b, j) takes positions b*M + j + l*L, l < R. The
// forward: the DFT over l, then output k times e^{-2 pi i j k / M}. The
// adjoint: conj, times the same twiddle, the DFT, conj. The last stage
// (M = R, j = 0, no twiddle) reads or writes device memory itself: its
// butterfly b holds frequencies k2 = rev(b) + (N2 / R) k, k < R. N2C is
// N2 where the kernel was compiled for it (0: t.n2).
template <int R, int IO, int N2C, typename T>
__device__ __forceinline__ void stage(const Tile<T>& t, int M) {
    using V2 = typename Vec2<T>::type;
    const int n2 = N2C ? N2C : t.n2;
    T c[R], s[R];
    if constexpr ((R & (R - 1)) != 0) {
#pragma unroll
        for (int m = 0; m < R; ++m) {
            const V2 e = t.tab2[(n2 / R) * m];
            c[m] = e.x;
            s[m] = e.y;
        }
    }
    const int L = M / R, per = n2 / R, step = n2 / M;
    const int W = 1 << t.lw, total = W * t.n1 * per;
    // butterfly `it`: its line w, group k1, block b and offset j
    auto locate = [&](int it, int& w, int& k1, int& b, int& j) {
        if constexpr (IO == kFwd || IO == kAdj) {
            // j fastest (per >= 16 butterflies a row but in the odd radix's
            // stage), so a half-warp's slots fall in distinct banks
            const int g = it % per, rest = it / per;
            w = rest & (W - 1);
            k1 = rest >> t.lw;
            b = g / L;
            j = g - b * L;
        } else if (t.inner != 1) {
            // columns: w fastest, so a warp's device accesses coalesce
            w = it & (W - 1);
            const int rest = it >> t.lw;
            b = rest % per;
            k1 = rest / per;
            j = 0;
        } else {
            // rows: b fastest (consecutive k2 where rev(b) = b)
            b = it % per;
            const int rest = it / per;
            w = rest & (W - 1);
            k1 = rest >> t.lw;
            j = 0;
        }
    };
    for (int it = t.tid; it < total; it += t.nt) {
        int w, k1, b, j;
        locate(it, w, k1, b, j);
        const int q0 = k1 * n2 + b * M + j, s0 = slot(w, q0, t.ls);
        // butterfly slot l: a constant offset from s0 where L is a multiple
        // of 16 (the padding period), or L = 1 and the R <= 16 points start
        // R-aligned (a power-of-two R); the odd radix's computed
        auto at = [&](int l) {
            return L % 16 == 0 ? s0 + l * (L + L / 16)
                : L == 1 && 16 % R == 0 ? s0 + l : slot(w, q0 + l * L, t.ls);
        };
        const bool live = t.l0 + w < t.nlines;
        V2 x[R];
        if constexpr (IO == kAdjRealIn) {
            const long long o = t.base[w] + static_cast<long long>(
                k1 * n2 + t.k2_of[b * R]) * t.inner;
#pragma unroll
            for (int l = 0; l < R; ++l)
                x[l] = {live ? t.in[o + static_cast<long long>(per * l)
                                     * t.inner] : T(0), T(0)};
        } else {
#pragma unroll
            for (int l = 0; l < R; ++l) x[l] = t.z[at(l)];
        }
        if constexpr (IO == kFwd) {
            dft<R, T>(x, c, s);
#pragma unroll
            for (int k = 1; k < R; ++k) {
                const V2 e = t.tab2[step * j * k];
                x[k] = rot(x[k], e.x, e.y);
            }
        } else if constexpr (IO == kAdj) {
#pragma unroll
            for (int k = 0; k < R; ++k) {
                const V2 e = t.tab2[step * j * k];
                x[k] = rot(cconj(x[k]), e.x, e.y);
            }
            dft<R, T>(x, c, s);
#pragma unroll
            for (int k = 0; k < R; ++k) x[k] = cconj(x[k]);
        } else if constexpr (IO == kFwdRealOut) {
            dft<R, T>(x, c, s);
            if (live) {
                const long long o = t.base[w] + static_cast<long long>(
                    k1 * n2 + t.k2_of[b * R]) * t.inner;
#pragma unroll
                for (int k = 0; k < R; ++k)
                    t.out[o + static_cast<long long>(per * k) * t.inner] =
                        x[k].x;
            }
            continue;
        } else {
            // kAdjRealIn, kTurn
            if constexpr (IO == kTurn) {
                dft<R, T>(x, c, s);
                const T lr = t.lr[w];
                const T* la = t.lam_axis + k1 * n2 + t.k2_of[b * R];
#pragma unroll
                for (int k = 0; k < R; ++k) {
                    const T d = la[per * k] + lr;
                    // float32: the fast division (2 ulp; an IEEE one a
                    // point cost the modal pass 11-18% on an H100, the
                    // ieee_div variant of fht_variants.py)
                    T q;
                    if constexpr (sizeof(T) == 4) q = __fdividef(t.norm, d);
                    else q = t.norm / d;
                    const T inv = fabs(d) < t.thr ? T(0) : q;
                    x[k] = {x[k].x * inv, T(0)};
                }
            }
            dft<R, T>(x, c, s);
#pragma unroll
            for (int k = 0; k < R; ++k) x[k] = cconj(x[k]);
        }
#pragma unroll
        for (int l = 0; l < R; ++l) t.z[at(l)] = x[l];
    }
}

// The stage of radix r (the odd radix is only ever the last stage).
template <int IO, int N2C, typename T>
__device__ __forceinline__ void run_stage(const Tile<T>& t, int r, int M) {
    switch (r) {
        case 16: stage<16, IO, N2C>(t, M); break;
        case 8: stage<8, IO, N2C>(t, M); break;
        case 4: stage<4, IO, N2C>(t, M); break;
        case 2: stage<2, IO, N2C>(t, M); break;
        default:
            if constexpr (IO != kFwd && IO != kAdj) {
                switch (r) {
                    case 3: stage<3, IO, N2C>(t, M); break;
                    case 5: stage<5, IO, N2C>(t, M); break;
                    default: stage<7, IO, N2C>(t, M); break;
                }
            }
    }
}

// A work item (w, m2) of W * n2: along z (rows) m2 fastest, along x or
// y (columns) w fastest, so that a warp's device accesses coalesce.
template <int N2C, typename T>
__device__ __forceinline__ void cas_item(const Tile<T>& t, int it, int& w,
                                         int& m2) {
    const int n2 = N2C ? N2C : t.n2;
    if (t.inner == 1) { w = it / n2; m2 = it - w * n2; }
    else { m2 = it >> t.lw; w = it & ((1 << t.lw) - 1); }
}

// The forward's first step, N1 a constant: load x[n1, m2] of each line,
// the cas stage over n1 and the twiddle, z[k1, m2] <- u_c + i u_s. A
// thread issues the loads of U items before it uses the first, so that
// ~16 loads a thread are in flight: one item's N1 alone left the pass
// waiting on device memory (the loads a block has in flight are what
// hides the latency; this stage is the only one that reads the field).
template <int N1, int N2C, typename T>
__device__ __forceinline__ void cas_in(const Tile<T>& t, const T* h1,
                                       const typename Vec2<T>::type* twn) {
    using V2 = typename Vec2<T>::type;
    constexpr int U = 16 / N1;
    const int n2 = N2C ? N2C : t.n2;
    const int total = n2 << t.lw;
    const long long stride = static_cast<long long>(n2) * t.inner;
    for (int i0 = t.tid; i0 < total; i0 += U * t.nt) {
        T x[U][N1];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int it = i0 + u * t.nt;
            int w = 0, m2 = 0;
            if (it < total) cas_item<N2C>(t, it, w, m2);
            const bool live = it < total && t.l0 + w < t.nlines;
            const T* src = t.in + t.base[w] + m2 * t.inner;
#pragma unroll
            for (int i = 0; i < N1; ++i)
                x[u][i] = live ? src[i * stride] : T(0);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int it = i0 + u * t.nt;
            if (it >= total) break;
            int w, m2;
            cas_item<N2C>(t, it, w, m2);
            T tt[N1];
#pragma unroll
            for (int k = 0; k < N1; ++k) {
                tt[k] = T(0);
#pragma unroll
                for (int i = 0; i < N1; ++i)
                    tt[k] = fma(h1[k * kMaxN1 + i], x[u][i], tt[k]);
            }
#pragma unroll
            for (int k = 0; k < N1; ++k) {
                const T tf = tt[(N1 - k) % N1];
                const V2 cs = twn[k * m2];
                t.z[slot(w, k * n2 + m2, t.ls)] = {cs.x * tt[k] + cs.y * tf,
                                                   cs.x * tf - cs.y * tt[k]};
            }
        }
    }
}

// The inverse's last step, N1 a constant: the twiddle and the cas stage
// over k1 from z[k1, m2] = v_c + i v_s, and the store of x[n1, m2].
template <int N1, int N2C, typename T>
__device__ __forceinline__ void cas_out(const Tile<T>& t, const T* h1,
                                        const typename Vec2<T>::type* twn) {
    using V2 = typename Vec2<T>::type;
    const int n2 = N2C ? N2C : t.n2;
    const long long stride = static_cast<long long>(n2) * t.inner;
    for (int it = t.tid; it < (n2 << t.lw); it += t.nt) {
        int w, m2;
        cas_item<N2C>(t, it, w, m2);
        if (t.l0 + w >= t.nlines) continue;
        T a1[N1], a2[N1];
#pragma unroll
        for (int k = 0; k < N1; ++k) {
            const V2 v = t.z[slot(w, k * n2 + m2, t.ls)];
            const V2 cs = twn[k * m2];
            a1[k] = cs.x * v.x - cs.y * v.y;
            a2[k] = cs.y * v.x + cs.x * v.y;
        }
        T* dst = t.out + t.base[w] + m2 * t.inner;
#pragma unroll
        for (int m1 = 0; m1 < N1; ++m1) {
            T o = T(0);
#pragma unroll
            for (int k = 0; k < N1; ++k) {
                o = fma(h1[m1 * kMaxN1 + k], a1[k], o);
                o = fma(h1[((N1 - k) % N1) * kMaxN1 + m1], a2[k], o);
            }
            dst[m1 * stride] = o;
        }
    }
}

// N2C: the N2 this instantiation is compiled for, its stages constants
// (each of the solver's splits), or 0 for any N2 the plan takes.
template <typename T, int MODE, int N2C>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 1)
fht_kernel(const T* __restrict__ in, T* __restrict__ out,
           const T* __restrict__ table, const T* __restrict__ lam_axis,
           const T* __restrict__ lam_rest, int n1, int n2_arg,
           long long inner, long long nlines, int lw, Plan plan, T thr,
           T norm) {
    using V2 = typename Vec2<T>::type;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ long long base[kMaxLines];
    __shared__ T lr[kMaxLines];
    const int n2 = N2C ? N2C : n2_arg;
    const int ns = N2C ? n_stages(N2C) : plan.ns;
    const int N = n1 * n2, ls = line_slots(N), W = 1 << lw;
    const int tid = threadIdx.x, nt = blockDim.x;
    T* sm = reinterpret_cast<T*>(smem_raw);
    V2* tab2 = reinterpret_cast<V2*>(sm);                      // n2 entries
    T* h1 = sm + 2 * n2;                                       // 8 x 8
    V2* z = reinterpret_cast<V2*>(h1 + kMaxN1 * kMaxN1);       // (W, ls)
    int* k2_of = reinterpret_cast<int*>(z + W * ls);           // n2
    // the N-entry twiddle table, read through L1
    const V2* twn = reinterpret_cast<const V2*>(table + 2 * n2);
    auto radix = [&](int i) { return N2C ? radix_at(N2C, i) : plan.radix[i]; };

    for (int i = tid; i < 2 * n2; i += nt) sm[i] = table[i];
    for (int i = tid; i < kMaxN1 * kMaxN1; i += nt)
        h1[i] = table[2 * n2 + 2 * N + i];
    for (int p = tid; p < n2; p += nt) {
        // position p = k_1 L_1 + k_2 L_2 + ... holds k_1 + R_1 k_2 + ...
        int rem = p, freq = 0, mul = 1, len = n2;
#pragma unroll
        for (int i = 0; i < kMaxStages; ++i) {
            if (i < ns) {
                len /= radix(i);
                const int d = rem / len;
                rem -= d * len;
                freq += d * mul;
                mul *= radix(i);
            }
        }
        k2_of[p] = freq;
    }
    const long long L0 = static_cast<long long>(blockIdx.x) * W;
    if (tid < W) {
        const long long L = L0 + tid;
        // line L: its points at base + n * inner
        base[tid] = (L / inner) * N * inner + L % inner;
        if (MODE == kModal) lr[tid] = L < nlines ? lam_rest[L] : T(0);
    }
    __syncthreads();

    const Tile<T> t{z, tab2, k2_of, base, lr, in, out, lam_axis, inner,
                    nlines, L0, n1, n2, lw, ls, tid, nt, thr, norm};
    const int last = ns - 1, rl = radix(last);
    if (MODE != kInverse) {
        // ---- load, the cas stage over n1 and the twiddle: z <- u ----------
        switch (n1) {
            case 1: cas_in<1, N2C>(t, h1, twn); break;
            case 2: cas_in<2, N2C>(t, h1, twn); break;
            case 3: cas_in<3, N2C>(t, h1, twn); break;
            case 4: cas_in<4, N2C>(t, h1, twn); break;
            case 5: cas_in<5, N2C>(t, h1, twn); break;
            case 6: cas_in<6, N2C>(t, h1, twn); break;
            case 7: cas_in<7, N2C>(t, h1, twn); break;
            default: cas_in<8, N2C>(t, h1, twn); break;
        }
        __syncthreads();
        // ---- the forward stages; the last one stores X (a pass) or turns
        int M = n2;
#pragma unroll
        for (int i = 0; i < kMaxStages - 1; ++i) {
            if (i < last) {
                run_stage<kFwd, N2C>(t, radix(i), M);
                M /= radix(i);
                __syncthreads();
            }
        }
        if (MODE == kForward) {
            run_stage<kFwdRealOut, N2C>(t, rl, rl);
            return;
        }
        run_stage<kTurn, N2C>(t, rl, rl);
    } else {
        // ---- load X and run the last stage's adjoint --------------------
        run_stage<kAdjRealIn, N2C>(t, rl, rl);
    }
    __syncthreads();

    // ---- the adjoint stages down to the first: natural order out --------
    {
        int M = rl;
#pragma unroll
        for (int i = kMaxStages - 2; i >= 0; --i) {
            if (i < last) {
                M *= radix(i);
                run_stage<kAdj, N2C>(t, radix(i), M);
                __syncthreads();
            }
        }
    }

    // ---- the twiddle and the cas stage over k1, and the store -----------
    switch (n1) {
        case 1: cas_out<1, N2C>(t, h1, twn); break;
        case 2: cas_out<2, N2C>(t, h1, twn); break;
        case 3: cas_out<3, N2C>(t, h1, twn); break;
        case 4: cas_out<4, N2C>(t, h1, twn); break;
        case 5: cas_out<5, N2C>(t, h1, twn); break;
        case 6: cas_out<6, N2C>(t, h1, twn); break;
        case 7: cas_out<7, N2C>(t, h1, twn); break;
        default: cas_out<8, N2C>(t, h1, twn); break;
    }
}

template <typename T, int MODE, int N2C>
int launch_n2(const void* in, void* out, const void* table,
              const void* lam_axis, const void* lam_rest, int n1, int n2,
              long long inner, long long nlines, int W, const Plan& plan,
              double thr, double norm, cudaStream_t stream) {
    const size_t smem = smem_bytes(n1, n2, W, sizeof(T));
    auto kernel = fht_kernel<T, MODE, N2C>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e) return static_cast<int>(e);
    }
    int lw = 0;
    while ((1 << lw) < W) ++lw;
    const unsigned blocks = static_cast<unsigned>((nlines + W - 1) / W);
    kernel<<<blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out),
        static_cast<const T*>(table), static_cast<const T*>(lam_axis),
        static_cast<const T*>(lam_rest), n1, n2, inner, nlines, lw, plan,
        static_cast<T>(thr), static_cast<T>(norm));
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int launch(const void* in, void* out, const void* table, const void* lam_axis,
           const void* lam_rest, int n1, int n2, long long inner,
           long long nlines, double thr, double norm, void* stream) {
    const int W = plan_tile(n1, n2, sizeof(T));
    Plan plan;
    if (!W || !plan_radices(n2, plan) || inner < 1 || nlines < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    // N2 = 128, the solver's split of every axis of 128 k points (k = 1
    // ... 8), has its plan compiled in; any other N2 runs it from `plan`
    if (n2 == 128)
        return launch_n2<T, MODE, 128>(in, out, table, lam_axis, lam_rest,
                                       n1, n2, inner, nlines, W, plan, thr,
                                       norm, s);
    return launch_n2<T, MODE, 0>(in, out, table, lam_axis, lam_rest, n1, n2,
                                 inner, nlines, W, plan, thr, norm, s);
}

}  // namespace


