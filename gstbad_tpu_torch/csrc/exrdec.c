/* exrdec.c — minimal OpenEXR decoder shim over the system OpenEXRCore
 * C API (the same library family the reference's ext/openexr wraps via
 * the C++ RgbaInputFile, gstopenexrdec.cpp:276-345).
 *
 * Exposes one function for ctypes:
 *
 *   int exrdec_decode_rgba(const uint8_t *data, uint64_t size,
 *                          float *out, int32_t *out_w, int32_t *out_h,
 *                          float *out_par);
 *
 * Two-call protocol: with out == NULL only the size/par query runs;
 * with out != NULL the pixels are decoded into PLANAR R,G,B,A float32
 * (four w*h planes; the caller interleaves) with RgbaInputFile's fill
 * semantics (missing R/G/B read as 0, missing A as 1, a lone "Y"
 * channel replicates into R=G=B).  Planar output is deliberate:
 * OpenEXRCore 3.1's interleaved fast path ignores the per-channel
 * decode_to_ptr ordering (it writes channels in file order from the
 * lowest pointer), so per-channel planes are the only layout whose
 * channel mapping the library honors.
 *
 * Returns 0 on success, negative shim codes on unsupported content
 * (-1 open failure, -2 not scanline/tiled single-part, -3 subsampled
 * channels (luma/chroma EXR), -4 decode error).
 *
 * Build: gcc -O2 -shared -fPIC -o libexrdec.so exrdec.c -lOpenEXRCore-3_1
 */

#include <openexr.h>
#include <stdint.h>
#include <string.h>

typedef struct {
    const uint8_t *data;
    uint64_t size;
} mem_stream_t;

static int64_t mem_read(exr_const_context_t ctxt, void *userdata,
                        void *buffer, uint64_t sz, uint64_t offset,
                        exr_stream_error_func_ptr_t error_cb) {
    mem_stream_t *ms = (mem_stream_t *) userdata;
    (void) ctxt;
    (void) error_cb;
    if (offset >= ms->size) return 0;
    if (offset + sz > ms->size) sz = ms->size - offset;
    memcpy(buffer, ms->data + offset, sz);
    return (int64_t) sz;
}

static int64_t mem_size(exr_const_context_t ctxt, void *userdata) {
    (void) ctxt;
    return (int64_t) ((mem_stream_t *) userdata)->size;
}

/* Map a channel name to its RGBA slot, or -1 to skip. */
static int chan_slot(const char *name, int *is_luma) {
    if (!strcmp(name, "R")) return 0;
    if (!strcmp(name, "G")) return 1;
    if (!strcmp(name, "B")) return 2;
    if (!strcmp(name, "A")) return 3;
    if (!strcmp(name, "Y")) { *is_luma = 1; return 0; }
    return -1;
}

static int decode_chunks(exr_context_t ctxt, float *out, int width,
                         int height, exr_attr_box2i_t dw, int *seen,
                         int *is_luma) {
    exr_storage_t storage;
    if (exr_get_storage(ctxt, 0, &storage) != EXR_ERR_SUCCESS)
        return -2;
    if (storage != EXR_STORAGE_SCANLINE && storage != EXR_STORAGE_TILED)
        return -2;

    if (storage == EXR_STORAGE_SCANLINE) {
        int32_t spc = 0;
        if (exr_get_scanlines_per_chunk(ctxt, 0, &spc) != EXR_ERR_SUCCESS)
            return -4;
        exr_decode_pipeline_t dec;
        memset(&dec, 0, sizeof(dec));
        int first = 1;
        for (int y = dw.min.y; y <= dw.max.y; y += spc) {
            exr_chunk_info_t cinfo;
            if (exr_read_scanline_chunk_info(ctxt, 0, y, &cinfo)
                    != EXR_ERR_SUCCESS)
                return -4;
            if (first) {
                if (exr_decoding_initialize(ctxt, 0, &cinfo, &dec)
                        != EXR_ERR_SUCCESS)
                    return -4;
            } else if (exr_decoding_update(ctxt, 0, &cinfo, &dec)
                       != EXR_ERR_SUCCESS) {
                exr_decoding_destroy(ctxt, &dec);
                return -4;
            }
            for (int c = 0; c < dec.channel_count; ++c) {
                exr_coding_channel_info_t *ch = &dec.channels[c];
                if (ch->x_samples != 1 || ch->y_samples != 1) {
                    exr_decoding_destroy(ctxt, &dec);
                    return -3;
                }
                int slot = chan_slot(ch->channel_name, is_luma);
                ch->user_bytes_per_element = 4;
                ch->user_data_type = EXR_PIXEL_FLOAT;
                ch->user_pixel_stride = (int32_t) sizeof(float);
                ch->user_line_stride = width * (int32_t) sizeof(float);
                if (slot < 0 || !out) {
                    ch->decode_to_ptr = NULL;
                } else {
                    seen[slot] = 1;
                    ch->decode_to_ptr = (uint8_t *)
                        (out + ((size_t) slot * height
                                + (y - dw.min.y)) * width);
                }
            }
            if (first) {
                if (exr_decoding_choose_default_routines(ctxt, 0, &dec)
                        != EXR_ERR_SUCCESS) {
                    exr_decoding_destroy(ctxt, &dec);
                    return -4;
                }
                first = 0;
            }
            if (out && exr_decoding_run(ctxt, 0, &dec) != EXR_ERR_SUCCESS) {
                exr_decoding_destroy(ctxt, &dec);
                return -4;
            }
            if (!out) break;  /* query: one chunk inspection is enough */
        }
        if (!first) exr_decoding_destroy(ctxt, &dec);
        return 0;
    }

    /* tiled, level (0,0) only (RgbaInputFile reads level 0) */
    uint32_t txsz = 0, tysz = 0;
    exr_tile_level_mode_t lm;
    exr_tile_round_mode_t rm;
    if (exr_get_tile_descriptor(ctxt, 0, &txsz, &tysz, &lm, &rm)
            != EXR_ERR_SUCCESS)
        return -4;
    int32_t levw = 0, levh = 0;
    if (exr_get_level_sizes(ctxt, 0, 0, 0, &levw, &levh) != EXR_ERR_SUCCESS)
        return -4;
    int32_t tcx = (levw + (int32_t) txsz - 1) / (int32_t) txsz;
    int32_t tcy = (levh + (int32_t) tysz - 1) / (int32_t) tysz;
    exr_decode_pipeline_t dec;
    memset(&dec, 0, sizeof(dec));
    int first = 1;
    for (int ty = 0; ty < tcy; ++ty) {
        for (int tx = 0; tx < tcx; ++tx) {
            exr_chunk_info_t cinfo;
            if (exr_read_tile_chunk_info(ctxt, 0, tx, ty, 0, 0, &cinfo)
                    != EXR_ERR_SUCCESS)
                return -4;
            if (first) {
                if (exr_decoding_initialize(ctxt, 0, &cinfo, &dec)
                        != EXR_ERR_SUCCESS)
                    return -4;
            } else if (exr_decoding_update(ctxt, 0, &cinfo, &dec)
                       != EXR_ERR_SUCCESS) {
                exr_decoding_destroy(ctxt, &dec);
                return -4;
            }
            int x0 = tx * (int) txsz, y0 = ty * (int) tysz;
            for (int c = 0; c < dec.channel_count; ++c) {
                exr_coding_channel_info_t *ch = &dec.channels[c];
                if (ch->x_samples != 1 || ch->y_samples != 1) {
                    exr_decoding_destroy(ctxt, &dec);
                    return -3;
                }
                int slot = chan_slot(ch->channel_name, is_luma);
                ch->user_bytes_per_element = 4;
                ch->user_data_type = EXR_PIXEL_FLOAT;
                ch->user_pixel_stride = (int32_t) sizeof(float);
                ch->user_line_stride = width * (int32_t) sizeof(float);
                if (slot < 0 || !out) {
                    ch->decode_to_ptr = NULL;
                } else {
                    seen[slot] = 1;
                    ch->decode_to_ptr = (uint8_t *)
                        (out + ((size_t) slot * height + y0) * width + x0);
                }
            }
            if (first) {
                if (exr_decoding_choose_default_routines(ctxt, 0, &dec)
                        != EXR_ERR_SUCCESS) {
                    exr_decoding_destroy(ctxt, &dec);
                    return -4;
                }
                first = 0;
            }
            if (out && exr_decoding_run(ctxt, 0, &dec) != EXR_ERR_SUCCESS) {
                exr_decoding_destroy(ctxt, &dec);
                return -4;
            }
            if (!out) goto done;
        }
    }
done:
    if (!first) exr_decoding_destroy(ctxt, &dec);
    return 0;
}

int exrdec_decode_rgba(const uint8_t *data, uint64_t size, float *out,
                       int32_t *out_w, int32_t *out_h, float *out_par) {
    mem_stream_t ms = {data, size};
    exr_context_initializer_t cinit = EXR_DEFAULT_CONTEXT_INITIALIZER;
    cinit.user_data = &ms;
    cinit.read_fn = mem_read;
    cinit.size_fn = mem_size;

    exr_context_t ctxt = NULL;
    if (exr_start_read(&ctxt, "<mem>", &cinit) != EXR_ERR_SUCCESS)
        return -1;

    exr_attr_box2i_t dw;
    if (exr_get_data_window(ctxt, 0, &dw) != EXR_ERR_SUCCESS) {
        exr_finish(&ctxt);
        return -1;
    }
    int width = dw.max.x - dw.min.x + 1;
    int height = dw.max.y - dw.min.y + 1;
    *out_w = width;
    *out_h = height;
    float par = 1.0f;
    exr_get_pixel_aspect_ratio(ctxt, 0, &par);
    *out_par = par;

    int rc = 0;
    int seen[4] = {0, 0, 0, 0};
    int is_luma = 0;
    size_t n = (size_t) width * height;
    if (out) {
        /* RgbaInputFile defaults: RGB 0, A 1 */
        for (size_t i = 0; i < 3 * n; ++i) out[i] = 0.0f;
        for (size_t i = 3 * n; i < 4 * n; ++i) out[i] = 1.0f;
    }
    rc = decode_chunks(ctxt, out, width, height, dw, seen, &is_luma);
    if (rc == 0 && out && is_luma && !seen[1] && !seen[2]) {
        memcpy(out + n, out, n * sizeof(float));
        memcpy(out + 2 * n, out, n * sizeof(float));
    }
    exr_finish(&ctxt);
    return rc;
}
