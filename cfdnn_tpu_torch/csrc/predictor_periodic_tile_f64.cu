// predictor_periodic, double: the kernel is predictor_periodic_tile.cuh's.
#include "predictor_periodic_tile.cuh"

extern "C" int cfdnn_predictor_periodic_f64(
        const void* u, const void* v, const void* w, const void* dt,
        void* su, void* sv, void* sw, int nx, int ny, int nz,
        double ihx, double ihy, double ihz, double nu, double fx,
        void* stream) {
    return launch<double>(u, v, w, dt, su, sv, sw, nx, ny, nz, ihx, ihy, ihz,
                          nu, fx, stream);
}
