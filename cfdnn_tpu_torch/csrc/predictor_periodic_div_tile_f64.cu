// predictor_periodic_div, double: the kernel is
// predictor_periodic_div_tile.cuh's.
#include "predictor_periodic_div_tile.cuh"

extern "C" int cfdnn_predictor_periodic_div_f64(
        const void* u, const void* v, const void* w, const void* dt,
        void* su, void* sv, void* sw, void* dv, int nx, int ny, int nz,
        double ihx, double ihy, double ihz, double nu, double fx,
        void* stream) {
    return launch_div<double>(u, v, w, dt, su, sv, sw, dv, nx, ny, nz, ihx,
                              ihy, ihz, nu, fx, stream);
}
