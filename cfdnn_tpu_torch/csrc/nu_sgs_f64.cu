// nu_sgs, double: the kernel is nu_sgs_tile.cuh's.
#include "nu_sgs_tile.cuh"

extern "C" int cfdnn_nu_sgs_f64(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, const void* den_x,
        const void* den_y, const void* den_z, const void* delta, void* out,
        int nx, int ny, int nz, int wall_y, int wall_z, int closure,
        double coeff, void* stream) {
    return launch<double>(u, v, w, inv_dx, inv_dy, inv_dz, den_x, den_y, den_z,
                          delta, out, nx, ny, nz, wall_y, wall_z, closure, coeff,
                          stream);
}
