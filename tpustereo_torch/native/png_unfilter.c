/* PNG row unfiltering (PNG specification, section 9.2), the inner loop of
 * `tpustereo_torch.data.io.read_png`.
 *
 * raw holds h rows of 1 + stride bytes: a row's filter type (0 None,
 * 1 Sub, 2 Up, 3 Average, 4 Paeth), then its filtered bytes. out receives
 * the h rows of stride unfiltered bytes. bpp is the filter's byte distance,
 * the bytes of one complete pixel rounded up to at least 1. The row above
 * the first is zero, as are the bytes left of a row's first pixel.
 *
 * Returns 0, or 1 + the index of the first row whose filter type is not
 * 0-4 (rows before it are decoded). Plain C with no library; the caller
 * (through ctypes) holds no interpreter lock during the call.
 */
#include <stdint.h>
#include <string.h>

/* The Paeth predictor: p - a = b - c, p - b = a - c, p - c = a + b - 2c,
 * written without branches (the selections become conditional moves,
 * which keep the serial chain through a short). */
static inline int paeth(int a, int b, int c)
{
    int pa = b - c, pb = a - c, pc = a + b - 2 * c;
    pa = pa < 0 ? -pa : pa;
    pb = pb < 0 ? -pb : pb;
    pc = pc < 0 ? -pc : pc;
    int bc = pb <= pc ? b : c;
    return (pa <= pb && pa <= pc) ? a : bc;
}

int64_t png_unfilter(const uint8_t *raw, uint8_t *out, int64_t h,
                     int64_t stride, int64_t bpp)
{
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t *src = raw + y * (stride + 1) + 1;
        uint8_t *dst = out + y * stride;
        const uint8_t *up = y ? dst - stride : NULL;
        int64_t x;
        switch (raw[y * (stride + 1)]) {
        case 0:
            memcpy(dst, src, (size_t)stride);
            break;
        case 1:
            for (x = 0; x < stride && x < bpp; ++x)
                dst[x] = src[x];
            for (; x < stride; ++x)
                dst[x] = (uint8_t)(src[x] + dst[x - bpp]);
            break;
        case 2:
            if (!up) {
                memcpy(dst, src, (size_t)stride);
                break;
            }
            for (x = 0; x < stride; ++x)
                dst[x] = (uint8_t)(src[x] + up[x]);
            break;
        case 3:
            if (bpp == 1 && up) {   /* the left byte stays in a register */
                int a = 0;
                for (x = 0; x < stride; ++x) {
                    a = (uint8_t)(src[x] + ((a + up[x]) >> 1));
                    dst[x] = (uint8_t)a;
                }
                break;
            }
            for (x = 0; x < stride; ++x) {
                int a = x >= bpp ? dst[x - bpp] : 0;
                int b = up ? up[x] : 0;
                dst[x] = (uint8_t)(src[x] + ((a + b) >> 1));
            }
            break;
        case 4:
            if (bpp == 1 && up) {   /* the left byte stays in a register */
                int a = 0, c = 0;
                for (x = 0; x < stride; ++x) {
                    int b = up[x];
                    a = (uint8_t)(src[x] + paeth(a, b, c));
                    dst[x] = (uint8_t)a;
                    c = b;
                }
                break;
            }
            for (x = 0; x < stride; ++x) {
                int a = x >= bpp ? dst[x - bpp] : 0;
                int b = up ? up[x] : 0;
                int c = (up && x >= bpp) ? up[x - bpp] : 0;
                dst[x] = (uint8_t)(src[x] + paeth(a, b, c));
            }
            break;
        default:
            return y + 1;
        }
    }
    return 0;
}
