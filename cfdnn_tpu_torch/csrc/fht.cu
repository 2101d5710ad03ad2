// The C entry points of the float32 fht_pass and the split check (the
// kernel is fht.cuh).
#include "fht.cuh"

// The lines a block of a split (0: the kernels refuse it).
extern "C" int cfdnn_fht_tile(int n1, int n2, int elem_size) {
    return plan_tile(n1, n2, static_cast<size_t>(elem_size));
}

extern "C" int cfdnn_fht_pass_f32(const void* in, void* out, const void* table,
                                  int n1, int n2, long long inner,
                                  long long nlines, int inverse, void* stream) {
    return inverse
        ? launch<float, kInverse>(in, out, table, nullptr, nullptr, n1, n2,
                                  inner, nlines, 0.0, 1.0, stream)
        : launch<float, kForward>(in, out, table, nullptr, nullptr, n1, n2,
                                  inner, nlines, 0.0, 1.0, stream);
}
