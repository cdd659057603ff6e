// A plain C interface to nvJPEG (CUDA toolkit) for the card's JPEG reader,
// cartseg_tpu_torch/utils/jpeg.py, called through ctypes.
//
// Built at the first JPEG read, apart from the kernel library, so that a
// toolkit without libnvjpeg fails JPEG reads only:
//   g++ -O2 -std=c++17 -shared -fPIC -I$CUDA_HOME/include nvjpeg_shim.cpp
//       -L$CUDA_HOME/lib64 -lnvjpeg -Wl,-rpath,$CUDA_HOME/lib64
//
// Every enum value and struct layout comes from nvjpeg.h. One handle serves
// the process; each decoding thread owns one nvjpegJpegState_t (a state
// must not be shared between threads). Each entry point returns the
// nvjpegStatus_t, 0 on success.

#include <cstddef>
#include <cstdint>

#include <nvjpeg.h>

extern "C" {

int cs_nvjpeg_create(void** handle) {
  nvjpegHandle_t h = nullptr;
  nvjpegStatus_t s = nvjpegCreateSimple(&h);
  *handle = h;
  return (int)s;
}

int cs_nvjpeg_state_create(void* handle, void** state) {
  nvjpegJpegState_t st = nullptr;
  nvjpegStatus_t s =
      nvjpegJpegStateCreate(static_cast<nvjpegHandle_t>(handle), &st);
  *state = st;
  return (int)s;
}

int cs_nvjpeg_state_destroy(void* state) {
  return (int)nvjpegJpegStateDestroy(static_cast<nvjpegJpegState_t>(state));
}

// Components, chroma subsampling (nvjpegChromaSubsampling_t) and the size
// of component 0, which is the image's size.
int cs_nvjpeg_info(void* handle, const unsigned char* data, size_t len,
                   int* components, int* subsampling, int* width,
                   int* height) {
  int w[NVJPEG_MAX_COMPONENT] = {0};
  int h[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t css = NVJPEG_CSS_UNKNOWN;
  nvjpegStatus_t s = nvjpegGetImageInfo(static_cast<nvjpegHandle_t>(handle),
                                        data, len, components, &css, w, h);
  *subsampling = (int)css;
  *width = w[0];
  *height = h[0];
  return (int)s;
}

// 1 for a subsampling this reader accepts: the ones nvJPEG names, not
// NVJPEG_CSS_UNKNOWN.
int cs_nvjpeg_known_subsampling(int css) {
  return css != (int)NVJPEG_CSS_UNKNOWN;
}

// Decode into device memory at `out` on `stream`: interleaved RGB
// (NVJPEG_OUTPUT_RGBI, pitch bytes a row) or, with gray != 0, the luma
// plane alone (NVJPEG_OUTPUT_Y).
int cs_nvjpeg_decode(void* handle, void* state, const unsigned char* data,
                     size_t len, int gray, unsigned char* out, size_t pitch,
                     void* stream) {
  nvjpegImage_t img;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    img.channel[c] = nullptr;
    img.pitch[c] = 0;
  }
  img.channel[0] = out;
  img.pitch[0] = pitch;
  return (int)nvjpegDecode(static_cast<nvjpegHandle_t>(handle),
                           static_cast<nvjpegJpegState_t>(state), data, len,
                           gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI, &img,
                           static_cast<cudaStream_t>(stream));
}

const char* cs_nvjpeg_status_name(int status) {
  switch ((nvjpegStatus_t)status) {
    case NVJPEG_STATUS_SUCCESS: return "NVJPEG_STATUS_SUCCESS";
    case NVJPEG_STATUS_NOT_INITIALIZED: return "NVJPEG_STATUS_NOT_INITIALIZED";
    case NVJPEG_STATUS_INVALID_PARAMETER:
      return "NVJPEG_STATUS_INVALID_PARAMETER";
    case NVJPEG_STATUS_BAD_JPEG: return "NVJPEG_STATUS_BAD_JPEG";
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED:
      return "NVJPEG_STATUS_JPEG_NOT_SUPPORTED";
    case NVJPEG_STATUS_ALLOCATOR_FAILURE:
      return "NVJPEG_STATUS_ALLOCATOR_FAILURE";
    case NVJPEG_STATUS_EXECUTION_FAILED: return "NVJPEG_STATUS_EXECUTION_FAILED";
    case NVJPEG_STATUS_ARCH_MISMATCH: return "NVJPEG_STATUS_ARCH_MISMATCH";
    case NVJPEG_STATUS_INTERNAL_ERROR: return "NVJPEG_STATUS_INTERNAL_ERROR";
    case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED:
      return "NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED";
    default: return "an nvjpegStatus_t this shim does not name";
  }
}

}  // extern "C"
