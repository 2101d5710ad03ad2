// The window of predictor_general_xz_o4_kernel (xz_o4_plan.cuh), exported
// for the tests and the A/B tool: `bytes` is the element size (4 or 8).
#include "xz_o4_plan.cuh"

extern "C" long long cfdnn_xz_o4_shared_bytes(int bytes, int nut, int y4) {
    return cfdnn::xz_o4::shared_bytes(bytes, nut != 0, y4 != 0);
}

extern "C" int cfdnn_xz_o4_slots(int bytes, int y4) {
    return cfdnn::xz_o4::slots(bytes, y4 != 0);
}

extern "C" int cfdnn_xz_o4_plane(void) { return cfdnn::xz_o4::kPlane; }

extern "C" int cfdnn_xz_o4_min_blocks(int bytes, int nut) {
    return cfdnn::xz_o4::min_blocks(bytes, nut != 0);
}
