// predictor_general, float: the kernel is predictor_general_tile.cuh's (its
// head says what it computes and how).
#include "predictor_general_tile.cuh"

extern "C" int cfdnn_predictor_general_f32(
        const void* u, const void* v, const void* w, const void* dt,
        const void* nut, void* su, void* sv, void* sw,
        const void* const* metrics, const double* tang, int nx, int ny,
        int nz, int wall_y, int wall_z, double nu, double fx, int scheme,
        void* stream) {
    return launch<float>(u, v, w, dt, nut, su, sv, sw, metrics, tang, nx, ny,
                         nz, wall_y, wall_z, nu, fx, scheme, stream);
}
