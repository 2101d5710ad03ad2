// predictor_channel_div, double: the kernel is
// predictor_channel_div_tile.cuh's.
#include "predictor_channel_div_tile.cuh"

extern "C" int cfdnn_predictor_channel_div_f64(
        const void* u, const void* v, const void* w, const void* dt,
        const void* inv_dy, const void* inv_dyc, const void* inv_dgy,
        const void* inv2_cy, const void* inv2_fy, const void* nut,
        void* su, void* sv, void* sw, void* dv, int nx, int ny, int nz,
        double ihx, double ihz, double nu, double fx, int skew,
        void* stream) {
    return launch_div<double>(u, v, w, dt, inv_dy, inv_dyc, inv_dgy, inv2_cy,
                              inv2_fy, nut, su, sv, sw, dv, nx, ny, nz, ihx,
                              ihz, nu, fx, skew, stream);
}
