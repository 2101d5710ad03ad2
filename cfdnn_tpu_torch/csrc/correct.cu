// correct: the O2 or O4 pressure correction u, v, w -= dt * grad(p) at
// the stored faces.
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_correct (body
// _correct_kernel, which runs ops.operators.pressure_grad_face on an
// x-slab, with a two-cell halo at O4). At face f of axis a, between cells
// f-1 and f:
//     grad = (p[f] - p[f-1]) * inv_dc_a[f]
// on an O2 axis, and on an O4 axis (mode 3 below) the reference's
// c2f_diff4,
//     grad = (27 (p[f] - p[f-1]) - (p[f+1] - p[f-2])) / (24 h_a),
// with the periodic wrap on a periodic axis, and on a bounded axis the
// Neumann copy ghost of bc.pad_pressure, which makes the gradient at the
// two boundary faces exactly zero: it is T(0) * inv_dc_a[f] there, as
// projection.cuh's face_grad writes it (a non-finite metric stays
// non-finite). The plain PyTorch twin is ops.operators.correct_velocity.
//
// Per axis a mode: 0 = the axis has one cell (its component is copied, as
// the operators do), 1 = periodic (N stored faces, face N wraps to 0),
// 2 = bounded (N+1 stored faces, boundary faces in the array), 3 =
// periodic at O4 (uniform, N >= 4; its inv_dc vector holds 24 h, the
// divisor, in its first N entries). Every mix of modes is served: the
// all-periodic box, the wall-y channel, the duct (walled y and z), a
// bounded x (the wall-x cavity), 2-D grids (nz = 1). The O4 terms are the
// kernel's O4 template argument: the launcher takes the O2 instantiation
// unless an axis is in mode 3, so the O2 code is the kernel's of before.
//
// Bound on the H100: device-memory bandwidth (u, v, w, p in, three faces
// out: 28 bytes a cell in float32, 9 flops). Design: one thread per cell
// (i, j, k), writing the three faces it owns (u at face i, v at face j, w
// at face k; a thread at the high end of a bounded axis also that axis's
// last face), so each of u, v and w is read and written once, coalesced
// along z. A block of kTx x kTz threads (z fastest, a warp wide) owns an
// (x, z) tile and walks its cells along y over a chunk of planes: p is
// read from device memory once a cell. The y neighbour p(i, j-1, k) is the
// thread's own register from the plane before; the x and z neighbours come
// from the plane of p staged in shared memory, the tile's own cells and,
// for the threads on its low x row and low z column, their neighbour
// outside the tile read by the thread itself (wrapped on a periodic axis).
// (On the H100, each thread reading its x and z neighbours from device
// memory, where a neighbouring warp's load has most likely put them in
// L1, was as fast at 512^3 and 4% slower at 256x128x256.) Each plane's
// operands are loaded one plane ahead, so a thread has two planes of
// loads in flight across the plane's barrier. 32-bit offsets: the wrapper
// refuses a field of more than 2^31 - 1 elements. The launcher picks the
// chunk of planes a block walks (tile_plan.cuh: two waves of blocks at
// least, 8 to 64 planes). At O4 the walk moves the same bytes: along y
// the thread's registers hold p's planes j - 2 and j - 1 and the next
// plane's load brings j + 1 beside j; along an O4 x or z the thread
// loads p at the offsets -2, -1 and +1 itself (wrapped; L1 hits, its
// neighbours' own cells).
#include "common.cuh"

namespace {

constexpr int kTx = 8;                  // x cells of a tile
constexpr int kTz = 32;                 // z cells: one warp
constexpr int kThreads = kTx * kTz;     // a thread per cell of the tile

// The row r of a periodic axis of n >= 4 cells, for r in [-2, n + 1].
__device__ __forceinline__ int wrap4(int r, int n) {
    return r < 0 ? r + n : (r >= n ? r - n : r);
}

template <typename T, bool O4>
__global__ void __launch_bounds__(kThreads)
correct_kernel(
        const T* __restrict__ u, const T* __restrict__ v,
        const T* __restrict__ w, const T* __restrict__ p,
        const T* __restrict__ dt_ptr, const T* __restrict__ inv_dcx,
        const T* __restrict__ inv_dcy, const T* __restrict__ inv_dcz,
        T* __restrict__ ou, T* __restrict__ ov, T* __restrict__ ow,
        int nx, int ny, int nz, int mx, int my, int mz, int chunk) {
    __shared__ T sp[2][kTx][kTz];       // p of the plane, two planes apart
    const int tiles_z = (nz + kTz - 1) / kTz;
    const int b = static_cast<int>(blockIdx.x);
    const int tx = static_cast<int>(threadIdx.x) / kTz;
    const int tz = static_cast<int>(threadIdx.x) % kTz;
    const int i = b / tiles_z * kTx + tx;
    const int k = b % tiles_z * kTz + tz;
    const int j0 = static_cast<int>(blockIdx.y) * chunk;
    const int j1 = min(j0 + chunk, ny);
    const bool owns = i < nx && k < nz;
    const int nfy = my == 2 ? ny + 1 : ny;
    const int nfz = mz == 2 ? nz + 1 : nz;
    const int sx = ny * nz;             // p's (and u's) x stride
    // whether this cell's x / z face is a pressure difference (not a
    // copied or a zero-gradient boundary face), the offset of the cell one
    // step down (wrapped on a periodic axis), and whether this thread reads
    // that neighbour itself
    const bool dx = mx == 1 || (mx == 2 && i > 0);
    const bool dz = mz == 1 || (mz == 2 && k > 0);
    const int ox = mx == 1 && i == 0 ? (nx - 1) * sx : -sx;
    const int oz = mz == 1 && k == 0 ? nz - 1 : -1;
    const bool load_x = owns && dx && tx == 0;
    const bool load_z = owns && dz && tz == 0;
    // (i, 0, k) in p and u, v, w
    const int cp = owns ? i * sx + k : 0;
    const int cv = owns ? i * nfy * nz + k : 0;
    const int cw = owns ? i * ny * nfz + k : 0;
    const T dt = *dt_ptr;
    // p one plane down: the plane before the chunk (the last one on a
    // periodic y)
    T p_prev = T(0);
    if (owns && (my == 1 || (my == 2 && j0 > 0)))
        p_prev = p[cp + (j0 > 0 ? j0 - 1 : ny - 1) * nz];
    // O4: p two planes down, and the offsets of p at i - 2, i - 1, i + 1
    // and k - 2, k - 1, k + 1 (wrapped)
    T p_m2 = T(0);
    int oxm1 = 0, oxm2 = 0, oxp1 = 0, ozm1 = 0, ozm2 = 0, ozp1 = 0;
    if constexpr (O4) {
        if (owns && my == 3) {
            p_prev = p[cp + wrap4(j0 - 1, ny) * nz];
            p_m2 = p[cp + wrap4(j0 - 2, ny) * nz];
        }
        if (mx == 3) {
            oxm1 = (wrap4(i - 1, nx) - i) * sx;
            oxm2 = (wrap4(i - 2, nx) - i) * sx;
            oxp1 = (wrap4(i + 1, nx) - i) * sx;
        }
        if (mz == 3) {
            ozm1 = wrap4(k - 1, nz) - k;
            ozm2 = wrap4(k - 2, nz) - k;
            ozp1 = wrap4(k + 1, nz) - k;
        }
    }
    // the operands of the next plane, loaded a plane ahead
    T pn = T(0), un = T(0), vn = T(0), wn = T(0), xn = T(0), zn = T(0);
    // (O4: p at j + 1 and at the x and z offsets)
    T yn1 = T(0), xm1 = T(0), xm2 = T(0), xp1 = T(0);
    T zm1 = T(0), zm2 = T(0), zp1 = T(0);
    auto fetch = [&](int j) {
        if (!owns) return;
        const int c = cp + j * nz;
        pn = p[c];
        un = u[c];
        vn = v[cv + j * nz];
        wn = w[cw + j * nfz];
        if (load_x) xn = p[c + ox];
        if (load_z) zn = p[c + oz];
        if constexpr (O4) {
            if (my == 3) yn1 = p[cp + wrap4(j + 1, ny) * nz];
            if (mx == 3) {
                xm1 = p[c + oxm1];
                xm2 = p[c + oxm2];
                xp1 = p[c + oxp1];
            }
            if (mz == 3) {
                zm1 = p[c + ozm1];
                zm2 = p[c + ozm2];
                zp1 = p[c + ozp1];
            }
        }
    };
    if (j0 < j1) fetch(j0);
    for (int j = j0; j < j1; ++j) {
        const T p0 = pn, uu = un, vv = vn, ww = wn;
        T pxm = xn, pzm = zn;
        const T p_p1 = yn1, px_m1 = xm1, px_m2 = xm2, px_p1 = xp1;
        const T pz_m1 = zm1, pz_m2 = zm2, pz_p1 = zp1;
        if (j + 1 < j1) fetch(j + 1);
        T (*s)[kTz] = sp[j & 1];
        s[tx][tz] = p0;
        __syncthreads();
        if (tx > 0) pxm = s[tx - 1][tz];
        if (tz > 0) pzm = s[tx][tz - 1];
        if (owns) {
            const int c = cp + j * nz;
            // u at face i (and face nx of a bounded x)
            if (mx == 0) {
                ou[c] = uu;
            } else {
                T g = dx ? (p0 - pxm) * inv_dcx[i] : T(0) * inv_dcx[i];
                // O4: inv_dcx is 24 h
                if constexpr (O4)
                    if (mx == 3)
                        g = (T(27) * (p0 - px_m1) - (px_p1 - px_m2))
                            / inv_dcx[i];
                ou[c] = uu - dt * g;
                if (mx == 2 && i == nx - 1)
                    ou[c + sx] = u[c + sx] - dt * (T(0) * inv_dcx[nx]);
            }
            // v at face j (and face ny of a bounded y)
            const int f = cv + j * nz;
            if (my == 0) {
                ov[f] = vv;
            } else {
                T g = my == 2 && j == 0 ? T(0) * inv_dcy[j]
                                        : (p0 - p_prev) * inv_dcy[j];
                if constexpr (O4)
                    if (my == 3)
                        g = (T(27) * (p0 - p_prev) - (p_p1 - p_m2))
                            / inv_dcy[j];
                ov[f] = vv - dt * g;
                if (my == 2 && j == ny - 1)
                    ov[f + nz] = v[f + nz] - dt * (T(0) * inv_dcy[ny]);
            }
            // w at face k (and face nz of a bounded z)
            const int e = cw + j * nfz;
            if (mz == 0) {
                ow[e] = ww;
            } else {
                T g = dz ? (p0 - pzm) * inv_dcz[k] : T(0) * inv_dcz[k];
                if constexpr (O4)
                    if (mz == 3)
                        g = (T(27) * (p0 - pz_m1) - (pz_p1 - pz_m2))
                            / inv_dcz[k];
                ow[e] = ww - dt * g;
                if (mz == 2 && k == nz - 1)
                    ow[e + 1] = w[e + 1] - dt * (T(0) * inv_dcz[nz]);
            }
        }
        if constexpr (O4) p_m2 = p_prev;
        p_prev = p0;
    }
}

template <typename T, bool O4>
int walk(const void* u, const void* v, const void* w, const void* p,
         const void* dt, const void* inv_dcx, const void* inv_dcy,
         const void* inv_dcz, void* ou, void* ov, void* ow, int nx, int ny,
         int nz, int mx, int my, int mz, int tiles, void* stream) {
    const int chunk = cfdnn::walk_chunk<correct_kernel<T, O4>, kThreads>(
        tiles, ny);
    const dim3 grid(static_cast<unsigned>(tiles),
                    static_cast<unsigned>((ny + chunk - 1) / chunk));
    correct_kernel<T, O4><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(p),
        static_cast<const T*>(dt), static_cast<const T*>(inv_dcx),
        static_cast<const T*>(inv_dcy), static_cast<const T*>(inv_dcz),
        static_cast<T*>(ou), static_cast<T*>(ov), static_cast<T*>(ow),
        nx, ny, nz, mx, my, mz, chunk);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* v, const void* w, const void* p,
           const void* dt, const void* inv_dcx, const void* inv_dcy,
           const void* inv_dcz, void* ou, void* ov, void* ow,
           int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    // 32-bit offsets for every face array
    const long long cx = nx, cy = ny, cz = nz;
    const long long n_u = (mx == 2 ? cx + 1 : cx) * cy * cz;
    const long long n_v = cx * (my == 2 ? cy + 1 : cy) * cz;
    const long long n_w = cx * cy * (mz == 2 ? cz + 1 : cz);
    const long long most = n_u > n_v ? (n_u > n_w ? n_u : n_w)
                                     : (n_v > n_w ? n_v : n_w);
    if (nx < 1 || ny < 1 || nz < 1 || most > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = ((nx + kTx - 1) / kTx) * ((nz + kTz - 1) / kTz);
    const int n[3] = {nx, ny, nz}, m[3] = {mx, my, mz};
    bool o4 = false;
    for (int a = 0; a < 3; ++a) {
        // mode 3: a periodic axis of at least four cells
        if (m[a] < 0 || m[a] > 3 || (m[a] == 3 && n[a] < 4))
            return static_cast<int>(cudaErrorInvalidValue);
        o4 = o4 || m[a] == 3;
    }
    if (o4)
        return walk<T, true>(u, v, w, p, dt, inv_dcx, inv_dcy, inv_dcz, ou,
                             ov, ow, nx, ny, nz, mx, my, mz, tiles, stream);
    return walk<T, false>(u, v, w, p, dt, inv_dcx, inv_dcy, inv_dcz, ou, ov,
                          ow, nx, ny, nz, mx, my, mz, tiles, stream);
}

}  // namespace

extern "C" int cfdnn_correct_f32(
        const void* u, const void* v, const void* w, const void* p,
        const void* dt, const void* inv_dcx, const void* inv_dcy,
        const void* inv_dcz, void* ou, void* ov, void* ow,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch<float>(u, v, w, p, dt, inv_dcx, inv_dcy, inv_dcz,
                         ou, ov, ow, nx, ny, nz, mx, my, mz, stream);
}

extern "C" int cfdnn_correct_f64(
        const void* u, const void* v, const void* w, const void* p,
        const void* dt, const void* inv_dcx, const void* inv_dcy,
        const void* inv_dcz, void* ou, void* ov, void* ow,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch<double>(u, v, w, p, dt, inv_dcx, inv_dcy, inv_dcz,
                          ou, ov, ow, nx, ny, nz, mx, my, mz, stream);
}
