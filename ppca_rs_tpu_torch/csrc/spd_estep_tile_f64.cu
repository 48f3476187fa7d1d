// The tile design of the E-step and of spd_chol (spd_estep_tile.cuh) in
// double, in a source of its own so that nvcc builds it beside the other
// sources.
#include "spd_estep_tile.cuh"

extern "C" int ppca_spd_estep_tile_f64(int want, const void* sigma, long long sigma_stride,
                                        const void* G, const void* b, const void* rnorm,
                                        const void* d_obs, void* s, void* m, void* llk, void* sq,
                                        long long B, int k, int layout, void* stream) {
  return static_cast<int>(ppca::tile::spd_estep_tile<double>(
      want, sigma, sigma_stride, G, b, rnorm, d_obs, s, m, llk, sq, B, k, layout != 0,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int ppca_spd_estep_tile_occupancy_f64(int k, int chol, int* ctas_per_sm, int* warps,
                                                  int* samples) {
  return static_cast<int>(
      ppca::tile::estep_tile_occupancy<double>(k, chol != 0, *ctas_per_sm, *warps, *samples));
}
