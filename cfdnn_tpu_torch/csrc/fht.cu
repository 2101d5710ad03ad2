// fht_pass and fht_modal: the four-step real Hartley transform of the
// "pallas_fft" Poisson solve, along one axis of a contiguous (X, Y, Z)
// array.
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
//            (digit-permuted: X[k1*N2 + k2] holds wavenumber k1 + N1*k2);
//   inverse  the unnormalized adjoint: v_c, v_s = sum_k2 (C2, S2)[k2 n2] X,
//            a1 = c v_c - s v_s, a2 = s v_c + c v_s,
//            x[n1] = sum_k H1[n1][k] a1[k] + H1[(N1 - k) % N1][n1] a2[k];
//   modal    forward, each mode times norm / (lam_axis[p] + lam_rest[line])
//            (0 where |lam_axis + lam_rest| < thr), then the inverse.
// C2/S2 are read from one N2-entry table of (cos, sin)(2 pi m / N2) at
// m = k2*n2 mod N2, the twiddles from one N-entry table at m = k1*n2 (< N).
//
// Bound on the H100: operations. The N2 contraction is 4*N2 flops an
// element a direction against 8 bytes moved (float32), so at N2 = 128 a
// pass needs ~1 ms of the card's 67 TFLOP/s and ~0.3 ms of its 3.35 TB/s.
// Design: a block takes W lines (W consecutive z columns along x or y, so
// each warp load is coalesced; W consecutive rows along z) and keeps them
// in shared memory, (N, W + 1) twice, for the whole transform: one read and
// one write of the field a pass, also for the modal pass. In the
// contraction a thread accumulates a tile of kR rows of one k1 group times
// kQ lines in registers, so each table entry it loads feeds kQ FMAs pairs
// and each data value kR. W shrinks with N and the dtype to fit shared
// memory (plan_tile); the tables and H1 are staged in shared memory too.
#include <cuda_runtime.h>

namespace {

constexpr int kR = 8;          // rows (k2 or n2) of a thread's tile
constexpr int kQ = 4;          // lines of a thread's tile
constexpr int kMaxN1 = 8;
constexpr int kMaxThreads = 512;
// dynamic shared memory: the opt-in limit of a block (227 KB) less the
// static arrays, and the size below which three blocks share an SM
constexpr size_t kMaxSmem = 227 * 1024 - 1024;
constexpr size_t kTargetSmem = 76000;
constexpr int kMaxLines = kQ * 8;

enum Mode { kForward = 0, kInverse = 1, kModal = 2 };

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

size_t smem_bytes(int n1, int n2, int lines, size_t esz) {
    const size_t n = static_cast<size_t>(n1) * n2;
    return esz * (2 * static_cast<size_t>(n2) + 2 * n + 2 * kMaxN1 * kMaxN1
                  + 2 * n * (lines + 1));
}

int threads_for(int n1, int n2, int tw) { return n1 * (n2 / kR) * tw; }

// The lines-per-block factor tw (W = kQ * tw): the largest of 8, 4, 2, 1
// whose block fits kTargetSmem (else the largest that fits kMaxSmem) with
// at most kMaxThreads threads; 0 where none does or the split is not one
// the kernel takes.
int plan_tile(int n1, int n2, size_t esz) {
    if (n1 < 1 || n1 > kMaxN1 || n2 < kR || n2 % kR) return 0;
    const size_t caps[2] = {kTargetSmem, kMaxSmem};
    for (size_t cap : caps) {
        for (int tw = 8; tw >= 1; tw /= 2) {
            if (threads_for(n1, n2, tw) <= kMaxThreads
                    && smem_bytes(n1, n2, kQ * tw, esz) <= cap)
                return tw;
        }
    }
    return 0;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
fht_kernel(const T* __restrict__ in, T* __restrict__ out,
           const T* __restrict__ table, const T* __restrict__ lam_axis,
           const T* __restrict__ lam_rest, int n1, int n2, long long inner,
           long long nlines, int tw_n, T thr, T norm) {
    using V2 = typename Vec2<T>::type;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ long long base[kMaxLines];
    __shared__ T lr[kMaxLines];
    const int N = n1 * n2, W = kQ * tw_n, Wp = W + 1;
    const int tid = threadIdx.x, nt = blockDim.x;
    T* sm = reinterpret_cast<T*>(smem_raw);
    const V2* tab2 = reinterpret_cast<const V2*>(sm);          // n2 entries
    const V2* twn = tab2 + n2;                                 // N entries
    const T* h1 = sm + 2 * n2 + 2 * N;                         // 8 x 8
    const T* h1f = h1 + kMaxN1 * kMaxN1;                       // 8 x 8
    T* A = sm + 2 * n2 + 2 * N + 2 * kMaxN1 * kMaxN1;          // (N, Wp)
    T* B = A + N * Wp;                                         // (N, Wp)

    const int ntab = 2 * n2 + 2 * N + 2 * kMaxN1 * kMaxN1;
    for (int i = tid; i < ntab; i += nt) sm[i] = table[i];
    const long long L0 = static_cast<long long>(blockIdx.x) * W;
    if (tid < W) {
        const long long L = L0 + tid;
        // line L: its points at base + n * inner
        base[tid] = (L / inner) * N * inner + L % inner;
        if (MODE == kModal) lr[tid] = L < nlines ? lam_rest[L] : T(0);
    }
    __syncthreads();

    // ---- load the W lines into A (n, w) -------------------------------
    for (int it = tid; it < N * W; it += nt) {
        int n, w;
        if (inner == 1) { w = it / N; n = it - w * N; }   // rows: along n
        else { n = it / W; w = it - n * W; }              // columns: along w
        T v = T(0);
        if (L0 + w < nlines) v = in[base[w] + n * inner];
        A[n * Wp + w] = v;
    }
    __syncthreads();

    const int tw = tid % tw_n, tk = tid / tw_n;
    const int G = n2 / kR;
    const int k1 = tk / G, r0 = tk - k1 * G;     // rows r0 + j * G of group k1
    const int row0 = k1 * n2;

    if (MODE != kInverse) {
        // ---- cas stage over n1 and the twiddle: A <- u_c, B <- u_s ----
        for (int it = tid; it < n2 * W; it += nt) {
            const int m2 = it / W, w = it - m2 * W;
            T x[kMaxN1];
#pragma unroll
            for (int i = 0; i < kMaxN1; ++i)
                x[i] = i < n1 ? A[(i * n2 + m2) * Wp + w] : T(0);
#pragma unroll
            for (int q1 = 0; q1 < kMaxN1; ++q1) {
                if (q1 < n1) {
                    T tt = T(0), tf = T(0);
#pragma unroll
                    for (int i = 0; i < kMaxN1; ++i) {
                        if (i < n1) {
                            tt = fma(h1[q1 * kMaxN1 + i], x[i], tt);
                            tf = fma(h1f[q1 * kMaxN1 + i], x[i], tf);
                        }
                    }
                    const V2 cs = twn[q1 * m2];
                    A[(q1 * n2 + m2) * Wp + w] = cs.x * tt + cs.y * tf;
                    B[(q1 * n2 + m2) * Wp + w] = cs.x * tf - cs.y * tt;
                }
            }
        }
        __syncthreads();

        // ---- N2 contraction: rows k2 = r0 + j*G, lines tw*kQ + q -------
        T acc[kR][kQ];
        int idx[kR];
#pragma unroll
        for (int j = 0; j < kR; ++j) {
            idx[j] = 0;
#pragma unroll
            for (int q = 0; q < kQ; ++q) acc[j][q] = T(0);
        }
        const T* uc = A + row0 * Wp + tw * kQ;
        const T* us = B + row0 * Wp + tw * kQ;
        for (int m2 = 0; m2 < n2; ++m2) {
            T c[kQ], s[kQ];
#pragma unroll
            for (int q = 0; q < kQ; ++q) {
                c[q] = uc[m2 * Wp + q];
                s[q] = us[m2 * Wp + q];
            }
#pragma unroll
            for (int j = 0; j < kR; ++j) {
                const V2 cs = tab2[idx[j]];
#pragma unroll
                for (int q = 0; q < kQ; ++q) {
                    acc[j][q] = fma(cs.x, c[q], acc[j][q]);
                    acc[j][q] = fma(cs.y, s[q], acc[j][q]);
                }
                idx[j] += r0 + j * G;                 // (k2 * m2) mod n2
                if (idx[j] >= n2) idx[j] -= n2;
            }
        }
        if (MODE == kModal) {
#pragma unroll
            for (int j = 0; j < kR; ++j) {
                const T la = lam_axis[row0 + r0 + j * G];
#pragma unroll
                for (int q = 0; q < kQ; ++q) {
                    const T d = la + lr[tw * kQ + q];
                    const T inv = fabs(d) < thr ? T(0) : norm / d;
                    acc[j][q] *= inv;
                }
            }
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kR; ++j)
#pragma unroll
            for (int q = 0; q < kQ; ++q)
                A[(row0 + r0 + j * G) * Wp + tw * kQ + q] = acc[j][q];
        __syncthreads();
    }

    if (MODE != kForward) {
        // ---- N2 contraction: v_c, v_s at rows n2 = r0 + j*G ------------
        T vc[kR][kQ], vs[kR][kQ];
        int idx[kR];
#pragma unroll
        for (int j = 0; j < kR; ++j) {
            idx[j] = 0;
#pragma unroll
            for (int q = 0; q < kQ; ++q) vc[j][q] = vs[j][q] = T(0);
        }
        const T* X = A + row0 * Wp + tw * kQ;
        for (int m2 = 0; m2 < n2; ++m2) {
            T x[kQ];
#pragma unroll
            for (int q = 0; q < kQ; ++q) x[q] = X[m2 * Wp + q];
#pragma unroll
            for (int j = 0; j < kR; ++j) {
                const V2 cs = tab2[idx[j]];
#pragma unroll
                for (int q = 0; q < kQ; ++q) {
                    vc[j][q] = fma(cs.x, x[q], vc[j][q]);
                    vs[j][q] = fma(cs.y, x[q], vs[j][q]);
                }
                idx[j] += r0 + j * G;                 // (m2 * n2) mod n2
                if (idx[j] >= n2) idx[j] -= n2;
            }
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kR; ++j)
#pragma unroll
            for (int q = 0; q < kQ; ++q) {
                const int a = (row0 + r0 + j * G) * Wp + tw * kQ + q;
                A[a] = vc[j][q];
                B[a] = vs[j][q];
            }
        __syncthreads();

        // ---- twiddle and the cas stage over k1: A <- x ------------------
        for (int it = tid; it < n2 * W; it += nt) {
            const int m2 = it / W, w = it - m2 * W;
            T a1[kMaxN1], a2[kMaxN1];
#pragma unroll
            for (int k = 0; k < kMaxN1; ++k) {
                a1[k] = a2[k] = T(0);
                if (k < n1) {
                    const T c = A[(k * n2 + m2) * Wp + w];
                    const T s = B[(k * n2 + m2) * Wp + w];
                    const V2 cs = twn[k * m2];
                    a1[k] = cs.x * c - cs.y * s;
                    a2[k] = cs.y * c + cs.x * s;
                }
            }
#pragma unroll
            for (int m1 = 0; m1 < kMaxN1; ++m1) {
                if (m1 < n1) {
                    T o = T(0);
#pragma unroll
                    for (int k = 0; k < kMaxN1; ++k) {
                        if (k < n1) {
                            o = fma(h1[m1 * kMaxN1 + k], a1[k], o);
                            o = fma(h1f[k * kMaxN1 + m1], a2[k], o);
                        }
                    }
                    A[(m1 * n2 + m2) * Wp + w] = o;
                }
            }
        }
        __syncthreads();
    }

    // ---- store A (n, w) -------------------------------------------------
    for (int it = tid; it < N * W; it += nt) {
        int n, w;
        if (inner == 1) { w = it / N; n = it - w * N; }
        else { n = it / W; w = it - n * W; }
        if (L0 + w < nlines) out[base[w] + n * inner] = A[n * Wp + w];
    }
}

template <typename T, int MODE>
int launch(const void* in, void* out, const void* table, const void* lam_axis,
           const void* lam_rest, int n1, int n2, long long inner,
           long long nlines, double thr, double norm, void* stream) {
    const int tw = plan_tile(n1, n2, sizeof(T));
    if (!tw || inner < 1 || nlines < 1) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_bytes(n1, n2, kQ * tw, sizeof(T));
    auto kernel = fht_kernel<T, MODE>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e) return static_cast<int>(e);
    }
    const long long lines = static_cast<long long>(kQ) * tw;
    const unsigned blocks = static_cast<unsigned>((nlines + lines - 1) / lines);
    kernel<<<blocks, threads_for(n1, n2, tw), smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(in), static_cast<T*>(out),
        static_cast<const T*>(table), static_cast<const T*>(lam_axis),
        static_cast<const T*>(lam_rest), n1, n2, inner, nlines, tw,
        static_cast<T>(thr), static_cast<T>(norm));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The lines-per-block factor of a split (0: the kernels refuse it).
extern "C" int cfdnn_fht_tile(int n1, int n2, int elem_size) {
    return plan_tile(n1, n2, static_cast<size_t>(elem_size));
}

extern "C" int cfdnn_fht_pass_f32(const void* in, void* out, const void* table,
                                  int n1, int n2, long long inner,
                                  long long nlines, int inverse, void* stream) {
    return inverse
        ? launch<float, kInverse>(in, out, table, nullptr, nullptr, n1, n2,
                                  inner, nlines, 0.0, 1.0, stream)
        : launch<float, kForward>(in, out, table, nullptr, nullptr, n1, n2,
                                  inner, nlines, 0.0, 1.0, stream);
}

extern "C" int cfdnn_fht_pass_f64(const void* in, void* out, const void* table,
                                  int n1, int n2, long long inner,
                                  long long nlines, int inverse, void* stream) {
    return inverse
        ? launch<double, kInverse>(in, out, table, nullptr, nullptr, n1, n2,
                                   inner, nlines, 0.0, 1.0, stream)
        : launch<double, kForward>(in, out, table, nullptr, nullptr, n1, n2,
                                   inner, nlines, 0.0, 1.0, stream);
}

extern "C" int cfdnn_fht_modal_f32(const void* in, void* out, const void* table,
                                   const void* lam_axis, const void* lam_rest,
                                   int n1, int n2, long long inner,
                                   long long nlines, double thr, double norm,
                                   void* stream) {
    return launch<float, kModal>(in, out, table, lam_axis, lam_rest, n1, n2,
                                 inner, nlines, thr, norm, stream);
}

extern "C" int cfdnn_fht_modal_f64(const void* in, void* out, const void* table,
                                   const void* lam_axis, const void* lam_rest,
                                   int n1, int n2, long long inner,
                                   long long nlines, double thr, double norm,
                                   void* stream) {
    return launch<double, kModal>(in, out, table, lam_axis, lam_rest, n1, n2,
                                  inner, nlines, thr, norm, stream);
}
