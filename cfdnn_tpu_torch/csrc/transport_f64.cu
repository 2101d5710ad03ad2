// transport, double: the kernel is transport_tile.cuh's.
#include "transport_tile.cuh"

extern "C" int cfdnn_transport_f64(
        const void* u, const void* v, const void* w, const void* k,
        const void* om, const void* nut, const void* dt, const void* y_wall,
        const void* pin, const void* om_visc, void* k_out, void* om_out,
        void* nut_out, const void* const* metrics, const double* params,
        int nx, int ny, int nz, int wall_y, int wall_z, int model,
        void* stream) {
    return launch<double>(u, v, w, k, om, nut, dt, y_wall, pin, om_visc, k_out,
                          om_out, nut_out, metrics, params, nx, ny, nz, wall_y,
                          wall_z, model, stream);
}
