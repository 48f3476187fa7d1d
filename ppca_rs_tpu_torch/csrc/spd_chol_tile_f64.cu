// The register-tile Cholesky factor (spd_chol_tile.cuh) in double, in a
// source of its own so that nvcc builds it beside the other sources.
#include "spd_chol_tile.cuh"

extern "C" int ppca_spd_chol_tile_f64(const void* M, void* L, long long B, int k, void* stream) {
  return static_cast<int>(
      ppca::tile::spd_chol_tile<double>(M, L, B, k, static_cast<cudaStream_t>(stream)));
}
