// The C entry point of the float32 fht_modal (the kernel is fht.cuh).
#include "fht.cuh"

extern "C" int cfdnn_fht_modal_f32(const void* in, void* out, const void* table,
                                   const void* lam_axis, const void* lam_rest,
                                   int n1, int n2, long long inner,
                                   long long nlines, double thr, double norm,
                                   void* stream) {
    return launch<float, kModal>(in, out, table, lam_axis, lam_rest, n1, n2,
                                 inner, nlines, thr, norm, stream);
}
