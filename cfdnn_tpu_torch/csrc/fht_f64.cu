// The C entry point of the float64 fht_pass (the kernel is fht.cuh).
#include "fht.cuh"

extern "C" int cfdnn_fht_pass_f64(const void* in, void* out, const void* table,
                                  int n1, int n2, long long inner,
                                  long long nlines, int inverse, void* stream) {
    return inverse
        ? launch<double, kInverse>(in, out, table, nullptr, nullptr, n1, n2,
                                   inner, nlines, 0.0, 1.0, stream)
        : launch<double, kForward>(in, out, table, nullptr, nullptr, n1, n2,
                                   inner, nlines, 0.0, 1.0, stream);
}
