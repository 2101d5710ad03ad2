// The (x, z)-tiled LES and projection kernels: nu_sgs_xz, divergence_xz
// and correct_xz, the functions of nu_sgs.cu, divergence.cu and correct.cu
// on the tile of xz_tile.cuh, for grids whose y-z planes the reference's
// TPU slab cannot hold.
//
// Replace cfdnn_tpu/ops/pallas_kernels.py
//   fused_nu_sgs_xz     (body _nu_sgs_kernel_xz: the closure's model_fn
//                        on an (x, z) tile with its 3 x 3 neighbour blocks),
//   fused_divergence_xz (body _divergence_kernel_xz: ops.divergence on the
//                        5-block, corner-free tile _ext_xz_nc),
//   fused_correct_xz    (body _correct_kernel_xz: pressure_grad_face on
//                        the same 5-block tile of p).
// The plain PyTorch twins are the slab kernels' (ops/kernels.py
// nu_sgs_twin, divergence_twin, correct_twin): the turbulence algebra and
// the operator library. The stencils are the slab kernels' own (les.cuh
// LesGrid::gradient, projection.cuh div_cell and face_grad), expression
// for expression, rewritten over offsets from the thread's point: each
// operand is one shared-memory load at a fixed offset (View::at), with no
// wrap and no fold; the closures are les.cuh's nu_closure itself.
//
// Grid: periodic uniform x and z (the launchers refuse anything else), y
// periodic or bounded by stationary no-slip walls at any stretching.
//
// O4 (space_order 4; replacing the same two Pallas kernels at ng = 2):
// divergence_xz and correct_xz take the O4 template argument where x and z
// are O4 (mode 3: periodic, uniform, n >= 4; the wrappers pass 24 h in
// place of the metric, as to divergence.cu and correct.cu), and y is O4
// too where it is periodic with ny >= 4 (mode 3), O2 where walled or
// shorter. The stencils are the slab kernels' O4 terms, expression for
// expression: f2c_diff4, (27 (F[i+1] - F[i]) - (F[i+2] - F[i-1])) / 24 h,
// for the divergence, on a window with a two-cell high x/z halo and the
// planes j - 1 ... j + 2; c2f_diff4, (27 (p[f] - p[f-1]) - (p[f+1] -
// p[f-2])) / 24 h, for the gradient, on a window with a two-cell low halo
// and the planes j - 2 ... j + 1. A walled y keeps the O2 terms and the
// zero wall-face gradient. The O2 instantiations are the kernels of
// before. nu_sgs_xz needs no O4 variant: its strain is O2 at every order,
// as the reference's (fused_nu_sgs_xz takes ng = 1 at O4).
//
// Bound on the H100: device-memory bandwidth. nu_sgs_xz reads u, v, w and
// writes nu_t (16 bytes a cell in float32, ~100-250 flops); divergence_xz
// the same bytes and 6 flops; correct_xz reads u, v, w, p and writes
// three faces (28 bytes, 9 flops). Design: xz_tile.cuh's 8 x 32 tile
// walked along y, the next plane copied by cp.async. The window holds the
// y-planes each stencil reaches: j - 1 ... j + 1 (gradient), j ... j + 1
// (divergence: v's upper face), j - 1 ... j (gradient of p); correct_xz
// reads u, v, w at the point itself straight from device memory. The
// gradient's y ghosts (odd reflections at a wall) are compiled only into
// the planes next to a wall (EDGE).
#include <type_traits>

#include "les.cuh"
#include "xz_tile.cuh"

namespace {

using cfdnn::LesGrid;
using cfdnn::xz::Window;
using cfdnn::xz::fits;
using cfdnn::xz::kThreads;

// ---- nu_sgs_xz ---------------------------------------------------------

// LesGrid::gradient at the thread's point on the staged window r (u, v, w:
// fields 0, 1, 2), its order of evaluation: x and z periodic, so is y
// unless EDGE (a plane next to a wall of a walled y, where yc forms the
// odd reflection).
template <typename T, bool EDGE, typename View>
__device__ __forceinline__ void gradient(const LesGrid<T>& g, const View& r,
                                         int i, int k, T G[3][3]) {
    const T h = T(0.5);
    const int j = r.j, ny = g.ny;
    // yc<C>(di, j + dj, dk): the odd reflection beyond a wall
    auto yc = [&](auto c, int di, int dj, int dk) -> T {
        constexpr int C = decltype(c)::value;
        if (EDGE) {
            if (j + dj < 0) return -r.template at<C>(di, -j, dk);
            if (j + dj >= ny) return -r.template at<C>(di, ny - 1 - j, dk);
        }
        return r.template at<C>(di, dj, dk);
    };
    using U = std::integral_constant<int, 0>;
    using W = std::integral_constant<int, 2>;
    const T dy = g.den_y[j], dx = g.den_x[i], dz = g.den_z[k];
    // diagonal: staggered difference across the cell
    G[0][0] = (r.template at<0>(1, 0, 0) - r.template at<0>(0, 0, 0)) * g.inv_dx[i];
    G[1][1] = (r.template at<1>(0, 1, 0) - r.template at<1>(0, 0, 0)) * g.inv_dy[j];
    G[2][2] = (r.template at<2>(0, 0, 1) - r.template at<2>(0, 0, 0)) * g.inv_dz[k];
    // off the diagonal: central difference at the component's own
    // points, then the mean of the two points bounding the cell
    const T uy_lo = (yc(U{}, 0, 1, 0) - yc(U{}, 0, -1, 0)) / dy;
    const T uy_hi = (yc(U{}, 1, 1, 0) - yc(U{}, 1, -1, 0)) / dy;
    G[0][1] = h * (uy_lo + uy_hi);
    const T uz_lo = (r.template at<0>(0, 0, 1) - r.template at<0>(0, 0, -1)) / dz;
    const T uz_hi = (r.template at<0>(1, 0, 1) - r.template at<0>(1, 0, -1)) / dz;
    G[0][2] = h * (uz_lo + uz_hi);
    const T vx_lo = (r.template at<1>(1, 0, 0) - r.template at<1>(-1, 0, 0)) / dx;
    const T vx_hi = (r.template at<1>(1, 1, 0) - r.template at<1>(-1, 1, 0)) / dx;
    G[1][0] = h * (vx_lo + vx_hi);
    const T vz_lo = (r.template at<1>(0, 0, 1) - r.template at<1>(0, 0, -1)) / dz;
    const T vz_hi = (r.template at<1>(0, 1, 1) - r.template at<1>(0, 1, -1)) / dz;
    G[1][2] = h * (vz_lo + vz_hi);
    const T wx_lo = (r.template at<2>(1, 0, 0) - r.template at<2>(-1, 0, 0)) / dx;
    const T wx_hi = (r.template at<2>(1, 0, 1) - r.template at<2>(-1, 0, 1)) / dx;
    G[2][0] = h * (wx_lo + wx_hi);
    const T wy_lo = (yc(W{}, 0, 1, 0) - yc(W{}, 0, -1, 0)) / dy;
    const T wy_hi = (yc(W{}, 0, 1, 1) - yc(W{}, 0, -1, 1)) / dy;
    G[2][1] = h * (wy_lo + wy_hi);
}

// float32 at three blocks an SM, float64 at two
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 3 : 2;

template <typename T, int CLOSURE>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
nu_sgs_xz_kernel(LesGrid<T> g, const T* __restrict__ delta,
                 T* __restrict__ out, T coeff) {
    using Win = Window<T, 3, 1, 1>;
    using View = typename Win::View;
    __shared__ T buf[Win::kSize];
    Win win;
    win.init(buf, g.nx, g.ny, g.nz, g.wall_y, g.ny);
    win.field(0, g.u, g.ny);
    win.field(1, g.v, g.nfy());
    win.field(2, g.w, g.ny);
    const int i = win.i, k = win.k;
    const bool owns = win.owns;
    win.walk([&](const View& view) {
        if (!owns) return;
        const int j = view.j;
        T G[3][3];
        if (g.wall_y && (j == 0 || j == g.ny - 1))
            gradient<T, true>(g, view, i, k, G);
        else
            gradient<T, false>(g, view, i, k, G);
        out[(i * g.ny + j) * g.nz + k] =
            cfdnn::nu_closure<T, CLOSURE>(G, delta + (j * g.nz + k), coeff);
    });
}

template <typename T, int CLOSURE>
void launch_closure(const LesGrid<T>& g, const T* delta, T* out, T coeff,
                    cudaStream_t stream) {
    nu_sgs_xz_kernel<T, CLOSURE>
        <<<cfdnn::xz::grid(g.nx, g.nz, g.ny), kThreads, 0, stream>>>(
            g, delta, out, coeff);
}

template <typename T>
int launch_nu_sgs(const void* u, const void* v, const void* w,
                  const void* inv_dx, const void* inv_dy, const void* inv_dz,
                  const void* den_x, const void* den_y, const void* den_z,
                  const void* delta, void* out, int nx, int ny, int nz,
                  int wall_y, int wall_z, int closure, double coeff,
                  void* stream) {
    if (wall_z || !fits(nx, wall_y ? ny + 1 : ny, nz))
        return static_cast<int>(cudaErrorInvalidValue);
    const LesGrid<T> g{static_cast<const T*>(u), static_cast<const T*>(v),
                       static_cast<const T*>(w), static_cast<const T*>(inv_dx),
                       static_cast<const T*>(inv_dy), static_cast<const T*>(inv_dz),
                       static_cast<const T*>(den_x), static_cast<const T*>(den_y),
                       static_cast<const T*>(den_z), nx, ny, nz, wall_y, 0};
    const T* d = static_cast<const T*>(delta);
    T* o = static_cast<T*>(out);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (closure) {
        case 0: launch_closure<T, 0>(g, d, o, T(coeff), s); break;
        case 1: launch_closure<T, 1>(g, d, o, T(coeff), s); break;
        case 2: launch_closure<T, 2>(g, d, o, T(coeff), s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// ---- divergence_xz -----------------------------------------------------

// div_cell with a periodic x and z (mx = mz = 1) and my = 1 (periodic)
// or 2 (walled): (face_hi - face_lo) * inv_d along x, then y, then z. O4:
// x and z in mode 3 (f2c_diff4 over the divisors 24 h in inv_dx, inv_dz),
// y in my = 3 (O4, inv_dy holding 24 h) or 1 or 2 (O2), with
// divergence.cu's O4 expressions and its first-term rule.
template <typename T, bool O4>
__global__ void __launch_bounds__(kThreads)
divergence_xz_kernel(const T* __restrict__ u, const T* __restrict__ v,
                     const T* __restrict__ w, const T* __restrict__ inv_dx,
                     const T* __restrict__ inv_dy, const T* __restrict__ inv_dz,
                     T* __restrict__ out, int nx, int ny, int nz, int my) {
    // O4: faces i - 1 ... i + 2 along each axis (a two-cell high halo,
    // the planes j - 1 ... j + 2)
    using Win = std::conditional_t<O4, Window<T, 3, 1, 2, 1, 2>,
                                   Window<T, 3, 0, 1>>;
    using View = typename Win::View;
    __shared__ T buf[Win::kSize];
    Win win;
    win.init(buf, nx, ny, nz, my == 2, ny);
    win.field(0, u, ny);
    win.field(1, v, my == 2 ? ny + 1 : ny);
    win.field(2, w, ny);
    const int i = win.i, k = win.k;
    const bool owns = win.owns;
    win.walk([&](const View& r) {
        if (!owns) return;
        const int j = r.j;
        if constexpr (O4) {
            T acc = (T(27) * (r.template at<0>(1, 0, 0) - r.template at<0>(0, 0, 0))
                     - (r.template at<0>(2, 0, 0) - r.template at<0>(-1, 0, 0)))
                    / inv_dx[i];
            T t;
            if (my == 3)
                t = (T(27) * (r.template at<1>(0, 1, 0) - r.template at<1>(0, 0, 0))
                     - (r.template at<1>(0, 2, 0) - r.template at<1>(0, -1, 0)))
                    / inv_dy[j];
            else
                t = (r.template at<1>(0, 1, 0) - r.template at<1>(0, 0, 0)) * inv_dy[j];
            acc = acc + t;
            acc = acc + (T(27) * (r.template at<2>(0, 0, 1) - r.template at<2>(0, 0, 0))
                         - (r.template at<2>(0, 0, 2) - r.template at<2>(0, 0, -1)))
                        / inv_dz[k];
            out[(i * ny + j) * nz + k] = acc;
        } else {
            T acc = (r.template at<0>(1, 0, 0) - r.template at<0>(0, 0, 0)) * inv_dx[i];
            acc = acc + (r.template at<1>(0, 1, 0) - r.template at<1>(0, 0, 0)) * inv_dy[j];
            acc = acc + (r.template at<2>(0, 0, 1) - r.template at<2>(0, 0, 0)) * inv_dz[k];
            out[(i * ny + j) * nz + k] = acc;
        }
    });
}

template <typename T, bool O4>
int walk_divergence(const void* u, const void* v, const void* w,
                    const void* inv_dx, const void* inv_dy,
                    const void* inv_dz, void* out, int nx, int ny, int nz,
                    int my, void* stream) {
    divergence_xz_kernel<T, O4><<<cfdnn::xz::grid(nx, nz, ny), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(inv_dx),
        static_cast<const T*>(inv_dy), static_cast<const T*>(inv_dz),
        static_cast<T*>(out), nx, ny, nz, my);
    return static_cast<int>(cudaGetLastError());
}

// The modes the xz projection kernels take: x and z both periodic at O2
// (1) or both at O4 (3: n >= 4), y periodic (1), walled (2) or, with an O4
// x and z, periodic at O4 (3: ny >= 4). Whether they take the O4
// instantiation: `o4`.
inline bool xz_modes(int nx, int ny, int nz, int mx, int my, int mz,
                     bool& o4) {
    o4 = mx == 3;
    if (mx != mz || (mx != 1 && mx != 3) || my < 1 || my > (o4 ? 3 : 2))
        return false;
    return !(o4 && (nx < 4 || nz < 4 || (my == 3 && ny < 4)));
}

template <typename T>
int launch_divergence(const void* u, const void* v, const void* w,
                      const void* inv_dx, const void* inv_dy,
                      const void* inv_dz, void* out, int nx, int ny, int nz,
                      int mx, int my, int mz, void* stream) {
    bool o4;
    if (!xz_modes(nx, ny, nz, mx, my, mz, o4)
        || !fits(nx, my == 2 ? ny + 1 : ny, nz))
        return static_cast<int>(cudaErrorInvalidValue);
    return (o4 ? walk_divergence<T, true> : walk_divergence<T, false>)(
        u, v, w, inv_dx, inv_dy, inv_dz, out, nx, ny, nz, my, stream);
}

// ---- correct_xz --------------------------------------------------------

// face_grad of p at the three faces of the point: (p - p one cell down) *
// inv_dc, periodic along x and z; along y periodic (my = 1) or walled (my
// = 2: zero at the two wall faces, bc.pad_pressure's Neumann copy). O4:
// x and z in mode 3 (c2f_diff4 over the divisors 24 h in inv_dcx,
// inv_dcz), y in my = 3 (O4, inv_dcy holding 24 h) or 1 or 2 (O2), with
// correct.cu's O4 expressions.
template <typename T, bool O4>
__global__ void __launch_bounds__(kThreads)
correct_xz_kernel(const T* __restrict__ u, const T* __restrict__ v,
                  const T* __restrict__ w, const T* __restrict__ p,
                  const T* __restrict__ dt_ptr, const T* __restrict__ inv_dcx,
                  const T* __restrict__ inv_dcy, const T* __restrict__ inv_dcz,
                  T* __restrict__ ou, T* __restrict__ ov, T* __restrict__ ow,
                  int nx, int ny, int nz, int my) {
    // O4: cells f - 2 ... f + 1 along each axis (a two-cell low halo, the
    // planes j - 2 ... j + 1)
    using Win = std::conditional_t<O4, Window<T, 1, 2, 1, 1, 1, 0, 2>,
                                   Window<T, 1, 1, 0>>;
    using View = typename Win::View;
    __shared__ T buf[Win::kSize];
    const int nfy = my == 2 ? ny + 1 : ny;
    Win win;
    win.init(buf, nx, ny, nz, my == 2, nfy);
    win.field(0, p, ny);
    const T dt = *dt_ptr;
    const int i = win.i, k = win.k;
    const bool owns = win.owns;
    win.walk([&](const View& r) {
        if (!owns) return;
        const int j = r.j;
        if constexpr (O4) {
            if (j < ny) {
                const int c = (i * ny + j) * nz + k;
                const T p0 = r.template at<0>(0, 0, 0);
                ou[c] = u[c] - dt * ((T(27) * (p0 - r.template at<0>(-1, 0, 0))
                                      - (r.template at<0>(1, 0, 0)
                                         - r.template at<0>(-2, 0, 0)))
                                     / inv_dcx[i]);
                ow[c] = w[c] - dt * ((T(27) * (p0 - r.template at<0>(0, 0, -1))
                                      - (r.template at<0>(0, 0, 1)
                                         - r.template at<0>(0, 0, -2)))
                                     / inv_dcz[k]);
            }
            const int f = (i * nfy + j) * nz + k;
            T gy;
            if (my == 3)
                gy = (T(27) * (r.template at<0>(0, 0, 0) - r.template at<0>(0, -1, 0))
                      - (r.template at<0>(0, 1, 0) - r.template at<0>(0, -2, 0)))
                     / inv_dcy[j];
            else
                gy = my == 2 && (j == 0 || j == ny)
                         ? T(0) * inv_dcy[j]
                         : (r.template at<0>(0, 0, 0) - r.template at<0>(0, -1, 0))
                               * inv_dcy[j];
            ov[f] = v[f] - dt * gy;
        } else {
            if (j < ny) {
                const int c = (i * ny + j) * nz + k;
                const T p0 = r.template at<0>(0, 0, 0);
                ou[c] = u[c] - dt * ((p0 - r.template at<0>(-1, 0, 0)) * inv_dcx[i]);
                ow[c] = w[c] - dt * ((p0 - r.template at<0>(0, 0, -1)) * inv_dcz[k]);
            }
            const int f = (i * nfy + j) * nz + k;
            const T gy = my == 2 && (j == 0 || j == ny)
                             ? T(0) * inv_dcy[j]
                             : (r.template at<0>(0, 0, 0) - r.template at<0>(0, -1, 0))
                                   * inv_dcy[j];
            ov[f] = v[f] - dt * gy;
        }
    });
}

template <typename T, bool O4>
int walk_correct(const void* u, const void* v, const void* w, const void* p,
                 const void* dt, const void* inv_dcx, const void* inv_dcy,
                 const void* inv_dcz, void* ou, void* ov, void* ow, int nx,
                 int ny, int nz, int my, void* stream) {
    const int nfy = my == 2 ? ny + 1 : ny;
    correct_xz_kernel<T, O4><<<cfdnn::xz::grid(nx, nz, nfy), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(p),
        static_cast<const T*>(dt), static_cast<const T*>(inv_dcx),
        static_cast<const T*>(inv_dcy), static_cast<const T*>(inv_dcz),
        static_cast<T*>(ou), static_cast<T*>(ov), static_cast<T*>(ow),
        nx, ny, nz, my);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_correct(const void* u, const void* v, const void* w, const void* p,
                   const void* dt, const void* inv_dcx, const void* inv_dcy,
                   const void* inv_dcz, void* ou, void* ov, void* ow, int nx,
                   int ny, int nz, int mx, int my, int mz, void* stream) {
    bool o4;
    if (!xz_modes(nx, ny, nz, mx, my, mz, o4)
        || !fits(nx, my == 2 ? ny + 1 : ny, nz))
        return static_cast<int>(cudaErrorInvalidValue);
    return (o4 ? walk_correct<T, true> : walk_correct<T, false>)(
        u, v, w, p, dt, inv_dcx, inv_dcy, inv_dcz, ou, ov, ow, nx, ny, nz,
        my, stream);
}

}  // namespace

extern "C" int cfdnn_nu_sgs_xz_f32(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, const void* den_x,
        const void* den_y, const void* den_z, const void* delta, void* out,
        int nx, int ny, int nz, int wall_y, int wall_z, int closure,
        double coeff, void* stream) {
    return launch_nu_sgs<float>(u, v, w, inv_dx, inv_dy, inv_dz, den_x, den_y,
                                den_z, delta, out, nx, ny, nz, wall_y, wall_z,
                                closure, coeff, stream);
}

extern "C" int cfdnn_nu_sgs_xz_f64(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, const void* den_x,
        const void* den_y, const void* den_z, const void* delta, void* out,
        int nx, int ny, int nz, int wall_y, int wall_z, int closure,
        double coeff, void* stream) {
    return launch_nu_sgs<double>(u, v, w, inv_dx, inv_dy, inv_dz, den_x, den_y,
                                 den_z, delta, out, nx, ny, nz, wall_y, wall_z,
                                 closure, coeff, stream);
}

extern "C" int cfdnn_divergence_xz_f32(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, void* out,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch_divergence<float>(u, v, w, inv_dx, inv_dy, inv_dz, out,
                                    nx, ny, nz, mx, my, mz, stream);
}

extern "C" int cfdnn_divergence_xz_f64(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, void* out,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch_divergence<double>(u, v, w, inv_dx, inv_dy, inv_dz, out,
                                     nx, ny, nz, mx, my, mz, stream);
}

extern "C" int cfdnn_correct_xz_f32(
        const void* u, const void* v, const void* w, const void* p,
        const void* dt, const void* inv_dcx, const void* inv_dcy,
        const void* inv_dcz, void* ou, void* ov, void* ow,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch_correct<float>(u, v, w, p, dt, inv_dcx, inv_dcy, inv_dcz,
                                 ou, ov, ow, nx, ny, nz, mx, my, mz, stream);
}

extern "C" int cfdnn_correct_xz_f64(
        const void* u, const void* v, const void* w, const void* p,
        const void* dt, const void* inv_dcx, const void* inv_dcy,
        const void* inv_dcz, void* ou, void* ov, void* ow,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch_correct<double>(u, v, w, p, dt, inv_dcx, inv_dcy, inv_dcz,
                                  ou, ov, ow, nx, ny, nz, mx, my, mz, stream);
}
