// JPEG decode on the card with nvJPEG (the CUDA toolkit's library): the
// route where the machine has no libjpeg (schemanet_torch/data/jpeg.py
// chooses it by what is installed). A library of its own with a plain C
// interface, built by nvcc at first use and loaded with ctypes.
//
// The decode writes each file's component planes as decoded (Y, and Cb, Cr
// at their subsampled size: NVJPEG_OUTPUT_YUV; Y alone for a gray file)
// straight into a device buffer that the caller allocated, on the caller's
// stream; libjpeg's upsampling and colour conversion follow in a kernel
// (csrc/imagepipe.cu ycc_rgb_kernel). The pixels never come back to the host.
//
// The decode has a handle and a state of its own behind one mutex (a state
// serves one decode at a time); the header reads have another handle behind
// another mutex, so that the loader's threads read headers while a batch
// decodes and share nothing with it.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

nvjpegHandle_t g_handle = nullptr, g_info_handle = nullptr;
nvjpegJpegState_t g_state = nullptr;
std::mutex g_decode_mutex, g_info_mutex;

// the decode's handle and state (called under g_decode_mutex)
int ensure_decoder() {
    if (g_state != nullptr) return 0;
    nvjpegStatus_t s = g_handle ? NVJPEG_STATUS_SUCCESS : nvjpegCreateSimple(&g_handle);
    if (s != NVJPEG_STATUS_SUCCESS) {
        g_handle = nullptr;
        return (int)s;
    }
    return (int)nvjpegJpegStateCreate(g_handle, &g_state);
}

}  // namespace

extern "C" {

// Header of one file: 0 on success with (h, w), the number of components,
// nvJPEG's chroma subsampling code and the chroma planes' (h, w); else the
// nvjpegStatus_t.
int sn_nvjpeg_info(const uint8_t* data, long len, int* h, int* w, int* components,
                   int* subsampling, int* chroma_h, int* chroma_w) {
    std::lock_guard<std::mutex> lock(g_info_mutex);
    if (g_info_handle == nullptr) {
        nvjpegStatus_t c = nvjpegCreateSimple(&g_info_handle);
        if (c != NVJPEG_STATUS_SUCCESS) {
            g_info_handle = nullptr;
            return (int)c;
        }
    }
    int nc = 0;
    nvjpegChromaSubsampling_t ss;
    int widths[NVJPEG_MAX_COMPONENT] = {0};
    int heights[NVJPEG_MAX_COMPONENT] = {0};
    nvjpegStatus_t s = nvjpegGetImageInfo(g_info_handle, data, (size_t)len, &nc, &ss, widths,
                                          heights);
    if (s != NVJPEG_STATUS_SUCCESS) return (int)s;
    *h = heights[0];
    *w = widths[0];
    *components = nc;
    *subsampling = (int)ss;
    *chroma_h = nc > 1 ? heights[1] : 0;
    *chroma_w = nc > 1 ? widths[1] : 0;
    return 0;
}

// Decode n files, packed in `data` at byte offsets `byte_off` [n + 1], into
// the device buffer `dst`: plane c of file i at plane_off[3 i + c] with row
// pitch pitch[3 i + c]; a gray file (gray[i] = 1) has its Y plane only.
// Returns 0, or the nvjpegStatus_t of the first file that failed (1000 +
// the cudaError_t of a failed wait), its index in *failed.
int sn_nvjpeg_decode(int n, const uint8_t* data, const long* byte_off, const long* plane_off,
                     const int* pitch, const int* gray, uint8_t* dst, void* stream, int* failed) {
    std::lock_guard<std::mutex> lock(g_decode_mutex);
    int err = ensure_decoder();
    if (err) {
        *failed = 0;
        return err;
    }
    for (int i = 0; i < n; ++i) {
        nvjpegImage_t img;
        for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
            img.channel[c] = nullptr;
            img.pitch[c] = 0;
        }
        const int planes = gray[i] ? 1 : 3;
        for (int c = 0; c < planes; ++c) {
            img.channel[c] = dst + plane_off[3 * i + c];
            img.pitch[c] = (size_t)pitch[3 * i + c];
        }
        nvjpegStatus_t s = nvjpegDecode(g_handle, g_state, data + byte_off[i],
                                        (size_t)(byte_off[i + 1] - byte_off[i]),
                                        gray[i] ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV, &img,
                                        (cudaStream_t)stream);
        if (s != NVJPEG_STATUS_SUCCESS) {
            *failed = i;
            return (int)s;
        }
        // the next file reuses the state's buffers: this one's device work
        // must be done first (without the wait, two decodes of one batch
        // gave other pixels now and then)
        const cudaError_t e = cudaStreamSynchronize((cudaStream_t)stream);
        if (e != cudaSuccess) {
            *failed = i;
            return 1000 + (int)e;
        }
    }
    return 0;
}

}  // extern "C"
