// The chunk rule of tile_plan.cuh, exported for the tests.
#include "tile_plan.cuh"

extern "C" int cfdnn_tile_chunk(long long tiles, int rows, int resident) {
    return cfdnn::plan::chunk(tiles, rows, resident);
}
