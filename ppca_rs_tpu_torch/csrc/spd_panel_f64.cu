// The panel design (spd_panel.cuh) in double, in a source of its own so that
// nvcc builds it beside the other sources.
#include "spd_panel.cuh"

extern "C" int ppca_spd_panel_f64(int want, int device, const void* sigma, long long sigma_stride,
                                  const void* G, const void* b, const void* rnorm,
                                  const void* d_obs, void* s, void* m, void* llk, void* sq,
                                  void* work, long long B, int k, void* stream) {
  return static_cast<int>(ppca::panel::spd_panel<double>(want, device, sigma, sigma_stride, G, b,
                                                        rnorm, d_obs, s, m, llk, sq, work, B, k,
                                                        static_cast<cudaStream_t>(stream)));
}
