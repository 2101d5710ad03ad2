// germano_pass1, double: the kernels are germano_tile.cuh's.
#include "germano_tile.cuh"

extern "C" int cfdnn_germano_pass1_f64(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, const void* den_x,
        const void* den_y, const void* den_z, const void* delta,
        void* smag, void* partial, void* lm, void* mm,
        int nx, int ny, int nz, int wall_y, int wall_z, int n_partial,
        void* stream) {
    return launch_germano<double>(u, v, w, inv_dx, inv_dy, inv_dz, den_x,
                                  den_y, den_z, delta, smag, partial, lm, mm,
                                  nx, ny, nz, wall_y, wall_z, n_partial,
                                  stream);
}
