// The chunk of y planes a block walks, for the kernels on a walked (x, z)
// tile whose launcher picks its own (predictor_channel_tile.cuh,
// correct.cu; the xz kernels keep xz::kChunk): the longest chunk, at most
// kChunkMax, whose blocks (`tiles` tiles of a plane times the chunks of
// `rows` planes) still make two waves of the `resident` blocks the card
// holds at once; at least kChunkMin, and at least what keeps the chunks
// within the launch grid's y extent. At 512^3 the chunk is kChunkMax; a
// 128^3 channel gets ~1.6 waves of kChunkMin planes where kChunkMax would
// give it 0.4 wave. Plain C++, so that a host compiler builds it too
// (tile_plan.cu exports it).
#pragma once

namespace cfdnn {
namespace plan {

constexpr int kChunkMax = 64;
constexpr int kChunkMin = 8;
constexpr long long kMaxChunks = 65535;   // the launch grid's y extent

inline int chunk(long long tiles, int rows, int resident) {
    const long long held = resident > 1 ? resident : 1;
    long long c = tiles * rows / (2 * held);
    if (c > kChunkMax) c = kChunkMax;
    if (c < kChunkMin) c = kChunkMin;
    const long long least = (rows + kMaxChunks - 1) / kMaxChunks;
    return static_cast<int>(c > least ? c : least);
}

}  // namespace plan
}  // namespace cfdnn
