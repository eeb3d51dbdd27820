// JPEG decode on the host with libjpeg: the port's copy of ip_jpeg_dims and
// ip_decode_jpeg (native/src/imagepipe.cpp), so that it gives the JAX
// package's native decode's bytes. A library of its own, built with the
// host's C++ compiler at first use (schemanet_torch/data/jpeg.py): the CUDA
// kernels' library never links libjpeg.
//
// Refused, as by the JAX package's decode: anything libjpeg cannot read (a
// PNG named .JPEG) and anything it cannot convert to RGB (a CMYK JPEG).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErrorMgr {
    jpeg_error_mgr pub;
    std::jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
    JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
    std::longjmp(err->jump, 1);
}

}  // namespace

extern "C" {

// Read the header only; 0 on success with (h, w) and the number of
// components of the file (1 grayscale, 3 YCbCr or RGB, 4 CMYK or YCCK).
int sn_jpeg_dims(const uint8_t* buf, long len, int* h, int* w, int* components) {
    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), (unsigned long)len);
    jpeg_read_header(&cinfo, TRUE);
    *w = (int)cinfo.image_width;
    *h = (int)cinfo.image_height;
    *components = cinfo.num_components;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Decode to RGB uint8 HWC into the caller's `out` (h * w * 3 bytes); 0 on
// success, -1 where libjpeg refuses the file.
int sn_decode_jpeg(const uint8_t* buf, long len, uint8_t* out) {
    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), (unsigned long)len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    const int w = cinfo.output_width;
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out + (size_t)cinfo.output_scanline * w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// The component planes as libjpeg decodes them, before its upsampling and
// colour conversion (raw data out): plane c, downsampled_width x
// downsampled_height bytes, at out + offsets of the planes before it;
// dims[4 c .. 4 c + 3] = (w, h, h_samp_factor, v_samp_factor) and the
// return value the number of components (1 or 3), or -1 where refused.
// Used by the tests: the port's upsampling and colour conversion
// (ops/kernels/imagepipe.py ycc_to_rgb_reference) must give
// sn_decode_jpeg's bytes from these planes.
int sn_jpeg_planes(const uint8_t* buf, long len, uint8_t* out, long cap, int* dims) {
    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), (unsigned long)len);
    jpeg_read_header(&cinfo, TRUE);
    const int nc = cinfo.num_components;
    if (nc != 1 && nc != 3) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    cinfo.raw_data_out = TRUE;
    jpeg_start_decompress(&cinfo);
    std::vector<std::vector<uint8_t>> store(nc);
    std::vector<std::vector<JSAMPROW>> rows(nc);
    JSAMPARRAY planes[3];
    long at = 0;
    long plane_at[3];
    for (int c = 0; c < nc; ++c) {
        jpeg_component_info* comp = &cinfo.comp_info[c];
        const int pitch = comp->width_in_blocks * DCTSIZE;
        const int nrows = comp->v_samp_factor * DCTSIZE;
        store[c].assign((size_t)pitch * nrows, 0);
        rows[c].resize(nrows);
        for (int r = 0; r < nrows; ++r) rows[c][r] = store[c].data() + (size_t)r * pitch;
        planes[c] = rows[c].data();
        dims[4 * c] = (int)comp->downsampled_width;
        dims[4 * c + 1] = (int)comp->downsampled_height;
        dims[4 * c + 2] = comp->h_samp_factor;
        dims[4 * c + 3] = comp->v_samp_factor;
        plane_at[c] = at;
        at += (long)comp->downsampled_width * comp->downsampled_height;
    }
    if (at > cap) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    const int lines = cinfo.max_v_samp_factor * DCTSIZE;
    for (int imcu = 0; cinfo.output_scanline < cinfo.output_height; ++imcu) {
        jpeg_read_raw_data(&cinfo, planes, lines);
        for (int c = 0; c < nc; ++c) {
            jpeg_component_info* comp = &cinfo.comp_info[c];
            const int nrows = comp->v_samp_factor * DCTSIZE;
            for (int r = 0; r < nrows; ++r) {
                const long y = (long)imcu * nrows + r;
                if (y >= (long)comp->downsampled_height) break;
                std::memcpy(out + plane_at[c] + y * comp->downsampled_width, rows[c][r],
                            comp->downsampled_width);
            }
        }
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return nc;
}

}  // extern "C"
