// The shape of predictor_general_xz_o4_kernel's window
// (predictor_general_xz_o4.cuh, xz_o4_tile.cuh's `Ring`): the staged
// plane, the y planes it stages, the planes in flight, its shared-memory
// bytes and the blocks an SM it is built for. Plain C++, so that a host
// compiler builds it too (xz_o4_plan.cu exports it for the tests and the
// A/B tool).
//
// A plane of a field is staged as 12 rows (the tile's 8 x rows and a
// two-cell halo each side) of kPitch points: the tile's 32 z points at
// kLead ... kLead + 31, 16-byte aligned so that the interior is copied
// 16 bytes a copy, and the two-cell z halo at kLead - 2, kLead - 1 and
// kLead + 32, kLead + 33. The ring holds the planes j - R ... j + R of
// the current plane j (R = 2 where y is O4, 1 where it is O2) and AHEAD
// planes more in flight, one slot a plane, each slot u, v, w and, with
// nu_t, nu_t.
#pragma once

// constexpr on the host and, under nvcc, in device code too
#ifdef __CUDACC__
#define CFDNN_XZ_O4_HD __host__ __device__
#else
#define CFDNN_XZ_O4_HD
#endif

namespace cfdnn {
namespace xz_o4 {

constexpr int kHalo = 2;                  // x/z halo, cells each side
constexpr int kRows = 8 + 2 * kHalo;      // staged x rows of a plane
constexpr int kLead = 4;                  // the row's point of z = k0
constexpr int kPitch = kLead + 32 + 4;    // staged points a row
constexpr int kPlane = kRows * kPitch;    // ... of a plane

// the y planes staged either way of the current plane
CFDNN_XZ_O4_HD constexpr int reach(bool y4) { return y4 ? 2 : 1; }

// the planes in flight: two in float32, one in float64
CFDNN_XZ_O4_HD constexpr int ahead(int bytes) { return bytes == 4 ? 2 : 1; }

CFDNN_XZ_O4_HD constexpr int slots(int bytes, bool y4) {
    return 2 * reach(y4) + 1 + ahead(bytes);
}

// the dynamic shared memory of the ring, in bytes
CFDNN_XZ_O4_HD constexpr long long shared_bytes(int bytes, bool nut,
                                               bool y4) {
    return static_cast<long long>(slots(bytes, y4)) * (nut ? 4 : 3)
           * kPlane * bytes;
}

// the blocks an SM the kernel is built for (__launch_bounds__' minimum:
// at most 65536 / (256 x blocks) registers a thread): three in float32
// without nu_t, two with it (at three, nu_t's O2 diffusion spilled, and
// ran 6% slower on the box at 512^3) and in float64
CFDNN_XZ_O4_HD constexpr int min_blocks(int bytes, bool nut) {
    return bytes == 4 && !nut ? 3 : 2;
}

}  // namespace xz_o4
}  // namespace cfdnn
