// Native mesh-warp renderer (host path).
//
// Implements the same one-pass algorithm as render/stabilize.py — per-cell
// closed-form quad homographies, reference mask semantics (pixel belongs to
// a cell when its inverse-mapped point lands strictly inside the cell's
// integer bbox expanded by 1 px), later-cell-wins compositing, sentinel
// backward maps, crop-edge rules, and the anisotropic crop+stretch — as a
// multithreaded C++ kernel.
//
// Why it exists: stabilized displacement fields are tiny ((F, R+1, C+1, 2)
// floats) while rendered pixels are large.  With this renderer the API
// fetches only the displacements from the device and warps on the host,
// next to the decoder and encoder.
//
// C ABI consumed via ctypes (meshflow/render/host.py).  Built for the host
// at first use by meshflow/utils/native_build.py (g++ only).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct H33 {
    double m[9];
};

// Heckbert unit-square -> quad; corners [(0,0),(1,0),(0,1),(1,1)] order.
H33 unit_to_quad(const double* q) {
    // q: 4 corners x (x, y): tl, tr, bl, br
    const double ax = q[0], ay = q[1];
    const double bx = q[2], by = q[3];
    const double cx = q[4], cy = q[5];
    const double dx_ = q[6], dy_ = q[7];
    const double sx = ax - bx - cx + dx_;
    const double sy = ay - by - cy + dy_;
    const double d1x = bx - dx_, d1y = by - dy_;
    const double d2x = cx - dx_, d2y = cy - dy_;
    double den = d1x * d2y - d1y * d2x;
    if (std::fabs(den) < 1e-12) den = 1e-12;
    const double g = (sx * d2y - sy * d2x) / den;
    const double h = (d1x * sy - d1y * sx) / den;
    H33 out;
    out.m[0] = bx - ax + g * bx;
    out.m[1] = cx - ax + h * cx;
    out.m[2] = ax;
    out.m[3] = by - ay + g * by;
    out.m[4] = cy - ay + h * cy;
    out.m[5] = ay;
    out.m[6] = g;
    out.m[7] = h;
    out.m[8] = 1.0;
    return out;
}

H33 adjugate(const H33& m) {
    const double* a = m.m;
    H33 out;
    out.m[0] = a[4] * a[8] - a[5] * a[7];
    out.m[1] = a[2] * a[7] - a[1] * a[8];
    out.m[2] = a[1] * a[5] - a[2] * a[4];
    out.m[3] = a[5] * a[6] - a[3] * a[8];
    out.m[4] = a[0] * a[8] - a[2] * a[6];
    out.m[5] = a[2] * a[3] - a[0] * a[5];
    out.m[6] = a[3] * a[7] - a[4] * a[6];
    out.m[7] = a[1] * a[6] - a[0] * a[7];
    out.m[8] = a[0] * a[4] - a[1] * a[3];
    return out;
}

H33 matmul(const H33& a, const H33& b) {
    H33 out;
    for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) {
            double acc = 0;
            for (int k = 0; k < 3; ++k) acc += a.m[r * 3 + k] * b.m[k * 3 + c];
            out.m[r * 3 + c] = acc;
        }
    return out;
}

inline long grid_line(long i, long count, long dim) {
    // ceil((dim-1) * i / count)
    return ((dim - 1) * i + count - 1) / count;
}

void parallel_for(long n, const std::function<void(long, long)>& fn) {
    unsigned int workers = std::max(1u, std::thread::hardware_concurrency());
    workers = std::min<unsigned long>(workers, static_cast<unsigned long>(n));
    if (workers <= 1) {
        fn(0, n);
        return;
    }
    std::vector<std::thread> pool;
    long chunk = (n + workers - 1) / workers;
    for (unsigned int t = 0; t < workers; ++t) {
        long lo = t * chunk;
        long hi = std::min<long>(n, lo + chunk);
        if (lo >= hi) break;
        pool.emplace_back([&fn, lo, hi] { fn(lo, hi); });
    }
    for (auto& th : pool) th.join();
}

// Fill one frame's backward maps (map_x/map_y/pri) from its displacement
// fields, optionally restricted to the pixel region [ry0..ry1]x[rx0..rx1].
//
// The per-cell setup (homographies, bboxes) stays in double; the per-pixel
// loop runs in float32 with a reciprocal-multiply so gcc vectorizes it
// to the host's vector width (-march=native).
// Float32 shifts map values by <=1e-3 px vs the double path and flips cell
// membership on ~2e-6 of pixels at quad seams — both far below cv2.remap's
// 1/32-px fixed-point coordinate quantization and the +-1 px membership
// slack, and the same precision the device renderer uses (f32 everywhere).
//
// pri may be null when the caller only needs maps (mf_maps/mf_crop_edges):
// the sentinel in map_x already encodes "uncovered", and skipping the pri
// plane saves one full fill+store pass.
void rasterize_maps(
    const float* du, const float* ds, long height, long width,
    long mesh_rows, long mesh_cols, long rx0, long rx1, long ry0, long ry1,
    H33* hinv, float* map_x, float* map_y, int32_t* pri) {
    const long vc = mesh_cols + 1;
    const long rw = rx1 - rx0 + 1, rh = ry1 - ry0 + 1;

    // Per-cell inverse homography: stabilized quad -> unstab rect.
    for (long r = 0; r < mesh_rows; ++r) {
        for (long c = 0; c < mesh_cols; ++c) {
            double stab[8], unstab[8];
            int k = 0;
            for (int dr = 0; dr < 2; ++dr) {
                for (int dc = 0; dc < 2; ++dc) {
                    long vi = ((r + dr) * vc + (c + dc)) * 2;
                    double ux = static_cast<double>(
                        grid_line(c + dc, mesh_cols, width));
                    double uy = static_cast<double>(
                        grid_line(r + dr, mesh_rows, height));
                    unstab[k * 2] = ux;
                    unstab[k * 2 + 1] = uy;
                    stab[k * 2] = ux + (ds[vi] - du[vi]);
                    stab[k * 2 + 1] = uy + (ds[vi + 1] - du[vi + 1]);
                    ++k;
                }
            }
            hinv[r * mesh_cols + c] =
                matmul(unit_to_quad(unstab), adjugate(unit_to_quad(stab)));
        }
    }

    std::fill(map_x, map_x + rh * rw, static_cast<float>(width + 1));
    std::fill(map_y, map_y + rh * rw, static_cast<float>(height + 1));
    if (pri) std::fill(pri, pri + rh * rw, -1);

    // Rasterize cells in row-major order (later cells win via priority
    // compare == overwrite order of the reference).
    for (long r = 0; r < mesh_rows; ++r) {
        for (long c = 0; c < mesh_cols; ++c) {
            const H33& h = hinv[r * mesh_cols + c];
            const float left = static_cast<float>(grid_line(c, mesh_cols, width));
            const float right =
                static_cast<float>(grid_line(c + 1, mesh_cols, width));
            const float top = static_cast<float>(grid_line(r, mesh_rows, height));
            const float bottom =
                static_cast<float>(grid_line(r + 1, mesh_rows, height));
            // stabilized-space bbox of this cell's quad (+2 slack)
            double minx = 1e30, maxx = -1e30, miny = 1e30, maxy = -1e30;
            for (int dr = 0; dr < 2; ++dr)
                for (int dc = 0; dc < 2; ++dc) {
                    long vi = ((r + dr) * vc + (c + dc)) * 2;
                    double sxp = grid_line(c + dc, mesh_cols, width) +
                                 (ds[vi] - du[vi]);
                    double syp = grid_line(r + dr, mesh_rows, height) +
                                 (ds[vi + 1] - du[vi + 1]);
                    minx = std::min(minx, sxp);
                    maxx = std::max(maxx, sxp);
                    miny = std::min(miny, syp);
                    maxy = std::max(maxy, syp);
                }
            long x0 = std::max<long>(rx0, (long)std::floor(minx) - 2);
            long x1 = std::min<long>(rx1, (long)std::ceil(maxx) + 2);
            long y0 = std::max<long>(ry0, (long)std::floor(miny) - 2);
            long y1 = std::min<long>(ry1, (long)std::ceil(maxy) + 2);
            int32_t key = static_cast<int32_t>(r * mesh_cols + c);
            // Cells are rasterized in increasing key order, so when a pixel
            // is a member of this cell the store is unconditional (pri can
            // only hold a smaller key); the select form below is what gcc
            // if-converts into blends + vector stores.
            const float h0 = static_cast<float>(h.m[0]);
            const float h3 = static_cast<float>(h.m[3]);
            const float h6 = static_cast<float>(h.m[6]);
            for (long y = y0; y <= y1; ++y) {
                // row constants from the double homography, pixels in f32
                const float cx_ = static_cast<float>(h.m[1] * y + h.m[2]);
                const float cy_ = static_cast<float>(h.m[4] * y + h.m[5]);
                const float cd_ = static_cast<float>(h.m[7] * y + h.m[8]);
                const long row_base = (y - ry0) * rw - rx0;
                float* __restrict mx = map_x + row_base;
                float* __restrict my = map_y + row_base;
                if (pri) {
                    int32_t* __restrict pr = pri + row_base;
                    for (long x = x0; x <= x1; ++x) {
                        const float fx = static_cast<float>(x);
                        const float nd = h6 * fx + cd_;
                        const float rcp = 1.0f / nd;
                        const float qx = (h0 * fx + cx_) * rcp;
                        const float qy = (h3 * fx + cy_) * rcp;
                        const bool member =
                            std::fabs(nd) >= 1e-12f && qx > left - 1.0f &&
                            qx < right + 1.0f && qy > top - 1.0f &&
                            qy < bottom + 1.0f;
                        pr[x] = member ? key : pr[x];
                        mx[x] = member ? qx : mx[x];
                        my[x] = member ? qy : my[x];
                    }
                } else {
                    for (long x = x0; x <= x1; ++x) {
                        const float fx = static_cast<float>(x);
                        const float nd = h6 * fx + cd_;
                        const float rcp = 1.0f / nd;
                        const float qx = (h0 * fx + cx_) * rcp;
                        const float qy = (h3 * fx + cy_) * rcp;
                        const bool member =
                            std::fabs(nd) >= 1e-12f && qx > left - 1.0f &&
                            qx < right + 1.0f && qy > top - 1.0f &&
                            qy < bottom + 1.0f;
                        mx[x] = member ? qx : mx[x];
                        my[x] = member ? qy : my[x];
                    }
                }
            }
        }
    }
}

// Bilinear remap of one pixel (constant border outside the source).
// The four tap weights are computed once and shared across the three
// channels; the common all-taps-inside case takes a branch-free path.
// float accumulation differs from the former double path by ~1e-5, which
// can flip nearbyint at exact .5 ties on ~1e-5 of pixels — well inside
// the +-1 LSB parity gates vs the device renderer.
inline void remap_px(
    const uint8_t* src, long height, long width, float mx, float my,
    const uint8_t* border, uint8_t* px) {
    float fx0 = std::floor(mx), fy0 = std::floor(my);
    float ax = mx - fx0, ay = my - fy0;
    long ix0 = (long)fx0, iy0 = (long)fy0;
    float w00 = (1.0f - ax) * (1.0f - ay);
    float w01 = ax * (1.0f - ay);
    float w10 = (1.0f - ax) * ay;
    float w11 = ax * ay;
    if (ix0 >= 0 && iy0 >= 0 && ix0 + 1 < width && iy0 + 1 < height) {
        const uint8_t* p0 = src + (iy0 * width + ix0) * 3;
        const uint8_t* p1 = p0 + width * 3;
        for (int ch = 0; ch < 3; ++ch) {
            float v = w00 * p0[ch] + w01 * p0[3 + ch] + w10 * p1[ch] +
                      w11 * p1[3 + ch];
            float rounded = std::nearbyintf(v);
            px[ch] = (uint8_t)std::min(255.0f, std::max(0.0f, rounded));
        }
        return;
    }
    bool in00x = ix0 >= 0 && ix0 < width, in01x = ix0 + 1 >= 0 && ix0 + 1 < width;
    bool in0y = iy0 >= 0 && iy0 < height, in1y = iy0 + 1 >= 0 && iy0 + 1 < height;
    const uint8_t* r0 = src + iy0 * width * 3;
    const uint8_t* r1 = r0 + width * 3;
    for (int ch = 0; ch < 3; ++ch) {
        float v00 = (in00x && in0y) ? r0[ix0 * 3 + ch] : border[ch];
        float v01 = (in01x && in0y) ? r0[(ix0 + 1) * 3 + ch] : border[ch];
        float v10 = (in00x && in1y) ? r1[ix0 * 3 + ch] : border[ch];
        float v11 = (in01x && in1y) ? r1[(ix0 + 1) * 3 + ch] : border[ch];
        float v = w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11;
        float rounded = std::nearbyintf(v);
        px[ch] = (uint8_t)std::min(255.0f, std::max(0.0f, rounded));
    }
}

// One output row of the bilinear crop+stretch.  Shared by mf_render_cropped
// and mf_crop_resize so the fused path stays byte-identical to running the
// two stages separately.  x0/x1 are source column indices (into a row of
// `stride` pixels), wx the x fractions; sy0/sy1/wy the two source rows and
// y fraction.
inline void stretch_row(
    const uint8_t* src, long stride, const long* x0, const long* x1,
    const float* wx, long sy0, long sy1, float wy, long width,
    uint8_t* dst_row) {
    const uint8_t* ra = src + sy0 * stride * 3;
    const uint8_t* rb = src + sy1 * stride * 3;
    const float by = wy, ay = 1.0f - wy;
    for (long x = 0; x < width; ++x) {
        const uint8_t* p00 = ra + x0[x] * 3;
        const uint8_t* p01 = ra + x1[x] * 3;
        const uint8_t* p10 = rb + x0[x] * 3;
        const uint8_t* p11 = rb + x1[x] * 3;
        const float bx = wx[x], ax = 1.0f - bx;
        uint8_t* px = dst_row + x * 3;
        for (int ch = 0; ch < 3; ++ch) {
            float v = ay * (ax * p00[ch] + bx * p01[ch]) +
                      by * (ax * p10[ch] + bx * p11[ch]);
            float rounded = std::nearbyintf(v);
            px[ch] = (uint8_t)std::min(255.0f, std::max(0.0f, rounded));
        }
    }
}

}  // namespace

// Render stabilized frames + per-frame crop edges.
//
// frames:      (F, H, W, 3) uint8 BGR
// unstab_disp: (F, VR, VC, 2) float32 (VR = rows+1, VC = cols+1)
// stab_disp:   (F, VR, VC, 2) float32
// border:      3 uint8 BGR
// out_frames:  (F, H, W, 3) uint8 (written)
// out_edges:   (F, 4) int32 [left, top, right, bottom] (written)
extern "C" void mf_render(
    const uint8_t* frames, const float* unstab_disp, const float* stab_disp,
    long num_frames, long height, long width, long mesh_rows, long mesh_cols,
    const uint8_t* border, uint8_t* out_frames, int32_t* out_edges) {
    const long vr = mesh_rows + 1, vc = mesh_cols + 1;
    const long cells = mesh_rows * mesh_cols;

    parallel_for(num_frames, [&](long f0, long f1) {
        std::vector<float> map_x(height * width);
        std::vector<float> map_y(height * width);
        std::vector<int32_t> pri(height * width);
        std::vector<H33> hinv(cells);

        for (long f = f0; f < f1; ++f) {
            const float* du = unstab_disp + f * vr * vc * 2;
            const float* ds = stab_disp + f * vr * vc * 2;
            rasterize_maps(du, ds, height, width, mesh_rows, mesh_cols,
                           0, width - 1, 0, height - 1,
                           hinv.data(), map_x.data(), map_y.data(),
                           pri.data());

            // Remap (bilinear, constant border) + crop-edge scan.
            const uint8_t* src = frames + f * height * width * 3;
            uint8_t* dst = out_frames + f * height * width * 3;
            long e_left = 0, e_right = width - 1, e_top = 0,
                 e_bottom = height - 1;
            bool f_left = false, f_right = false, f_top = false,
                 f_bottom = false;
            for (long y = 0; y < height; ++y) {
                for (long x = 0; x < width; ++x) {
                    long idx = y * width + x;
                    float mx = map_x[idx], my = map_y[idx];
                    // crop-edge rules (reference :1075-1098)
                    if (std::fabs(mx) < 1.0f) {
                        if (!f_left || x > e_left) e_left = x;
                        f_left = true;
                    }
                    if (std::fabs(mx - (width - 1)) < 1.0f) {
                        if (!f_right || x < e_right) e_right = x;
                        f_right = true;
                    }
                    if (std::fabs(my) < 1.0f) {
                        if (!f_top || y > e_top) e_top = y;
                        f_top = true;
                    }
                    if (std::fabs(my - (height - 1)) < 1.0f) {
                        if (!f_bottom || y < e_bottom) e_bottom = y;
                        f_bottom = true;
                    }
                    uint8_t* px = dst + idx * 3;
                    if (pri[idx] < 0) {
                        px[0] = border[0];
                        px[1] = border[1];
                        px[2] = border[2];
                        continue;
                    }
                    remap_px(src, height, width, mx, my, border, px);
                }
            }
            out_edges[f * 4 + 0] = (int32_t)e_left;
            out_edges[f * 4 + 1] = (int32_t)e_top;
            out_edges[f * 4 + 2] = (int32_t)e_right;
            out_edges[f * 4 + 3] = (int32_t)e_bottom;
        }
    });
}

// Per-frame crop edges only (no pixel IO): identical map rasterization and
// edge-scan arithmetic to mf_render, so a streaming caller can learn the
// global crop rectangle from the displacement fields alone before any
// frame is re-decoded for rendering.
extern "C" void mf_crop_edges(
    const float* unstab_disp, const float* stab_disp, long num_frames,
    long height, long width, long mesh_rows, long mesh_cols,
    int32_t* out_edges) {
    const long vr = mesh_rows + 1, vc = mesh_cols + 1;
    const long cells = mesh_rows * mesh_cols;

    parallel_for(num_frames, [&](long f0, long f1) {
        std::vector<float> map_x(height * width);
        std::vector<float> map_y(height * width);
        std::vector<H33> hinv(cells);

        for (long f = f0; f < f1; ++f) {
            const float* du = unstab_disp + f * vr * vc * 2;
            const float* ds = stab_disp + f * vr * vc * 2;
            rasterize_maps(du, ds, height, width, mesh_rows, mesh_cols,
                           0, width - 1, 0, height - 1,
                           hinv.data(), map_x.data(), map_y.data(),
                           nullptr);
            long e_left = 0, e_right = width - 1, e_top = 0,
                 e_bottom = height - 1;
            bool f_left = false, f_right = false, f_top = false,
                 f_bottom = false;
            for (long y = 0; y < height; ++y) {
                for (long x = 0; x < width; ++x) {
                    long idx = y * width + x;
                    float mx = map_x[idx], my = map_y[idx];
                    if (std::fabs(mx) < 1.0f) {
                        if (!f_left || x > e_left) e_left = x;
                        f_left = true;
                    }
                    if (std::fabs(mx - (width - 1)) < 1.0f) {
                        if (!f_right || x < e_right) e_right = x;
                        f_right = true;
                    }
                    if (std::fabs(my) < 1.0f) {
                        if (!f_top || y > e_top) e_top = y;
                        f_top = true;
                    }
                    if (std::fabs(my - (height - 1)) < 1.0f) {
                        if (!f_bottom || y < e_bottom) e_bottom = y;
                        f_bottom = true;
                    }
                }
            }
            out_edges[f * 4 + 0] = (int32_t)e_left;
            out_edges[f * 4 + 1] = (int32_t)e_top;
            out_edges[f * 4 + 2] = (int32_t)e_right;
            out_edges[f * 4 + 3] = (int32_t)e_bottom;
        }
    });
}

// Fused warp + crop + stretch for a chunk, given the already-known global
// crop rectangle: stabilized pixels are produced only over the crop region
// (same uint8 rounding as mf_render's full-frame pass), then stretched to
// (W, H) with mf_crop_resize's exact sampling tables — byte-identical to
// running the two stages separately, at ~crop-area cost.
extern "C" void mf_render_cropped(
    const uint8_t* frames, const float* unstab_disp, const float* stab_disp,
    long num_frames, long height, long width, long mesh_rows, long mesh_cols,
    const uint8_t* border, int32_t left, int32_t top, int32_t right,
    int32_t bottom, uint8_t* out_frames) {
    const long vr = mesh_rows + 1, vc = mesh_cols + 1;
    const long cells = mesh_rows * mesh_cols;
    const long rw = right - left + 1, rh = bottom - top + 1;
    const double crop_w = rw, crop_h = rh;
    const double sx = crop_w / width;
    const double sy = crop_h / height;

    // Stretch sampling tables: global arithmetic bit-identical to
    // mf_crop_resize (frac of v+left, not of v), indices region-local.
    std::vector<long> xi(width), x1t(width), yi(height);
    std::vector<float> xf(width), yf(height);
    for (long x = 0; x < width; ++x) {
        double v = (x + 0.5) * sx - 0.5;
        v = std::min(std::max(v, 0.0), crop_w - 1.0) + left;
        long g = (long)std::floor(v);
        xi[x] = g - left;
        x1t[x] = std::min<long>(xi[x] + 1, rw - 1);
        xf[x] = (float)(v - g);
    }
    for (long y = 0; y < height; ++y) {
        double v = (y + 0.5) * sy - 0.5;
        v = std::min(std::max(v, 0.0), crop_h - 1.0) + top;
        long g = (long)std::floor(v);
        yi[y] = g - top;
        yf[y] = (float)(v - g);
    }

    parallel_for(num_frames, [&](long f0, long f1) {
        std::vector<float> map_x(rh * rw);
        std::vector<float> map_y(rh * rw);
        std::vector<int32_t> pri(rh * rw);
        std::vector<H33> hinv(cells);
        std::vector<uint8_t> stab(rh * rw * 3);

        for (long f = f0; f < f1; ++f) {
            const float* du = unstab_disp + f * vr * vc * 2;
            const float* ds = stab_disp + f * vr * vc * 2;
            rasterize_maps(du, ds, height, width, mesh_rows, mesh_cols,
                           left, right, top, bottom,
                           hinv.data(), map_x.data(), map_y.data(),
                           pri.data());

            const uint8_t* src = frames + f * height * width * 3;
            for (long idx = 0; idx < rh * rw; ++idx) {
                uint8_t* px = stab.data() + idx * 3;
                if (pri[idx] < 0) {
                    px[0] = border[0];
                    px[1] = border[1];
                    px[2] = border[2];
                    continue;
                }
                remap_px(src, height, width, map_x[idx], map_y[idx],
                         border, px);
            }

            uint8_t* dst = out_frames + f * height * width * 3;
            for (long y = 0; y < height; ++y) {
                long y0 = yi[y];
                long y1 = std::min<long>(y0 + 1, rh - 1);
                stretch_row(stab.data(), rw, xi.data(), x1t.data(),
                            xf.data(), y0, y1, yf[y], width,
                            dst + y * width * 3);
            }
        }
    });
}

// Backward maps for a chunk of frames over a pixel region, for callers
// that run the remap itself (the host binding feeds these to cv2.remap —
// the exact op the reference uses at meshflowstabilizer.py:1063 — whose
// fixed-point SIMD inner loop is far faster than a portable scalar one).
// Uncovered pixels keep the reference's sentinel (W+1, H+1), which remap
// with BORDER_CONSTANT turns into border color.
//
// out_maps: (F, 2, ry1-ry0+1, rx1-rx0+1) float32 — [map_x, map_y] planes.
extern "C" void mf_maps(
    const float* unstab_disp, const float* stab_disp, long num_frames,
    long height, long width, long mesh_rows, long mesh_cols,
    int32_t rx0, int32_t ry0, int32_t rx1, int32_t ry1, float* out_maps) {
    const long vr = mesh_rows + 1, vc = mesh_cols + 1;
    const long cells = mesh_rows * mesh_cols;
    const long rw = rx1 - rx0 + 1, rh = ry1 - ry0 + 1;

    parallel_for(num_frames, [&](long f0, long f1) {
        std::vector<H33> hinv(cells);
        for (long f = f0; f < f1; ++f) {
            const float* du = unstab_disp + f * vr * vc * 2;
            const float* ds = stab_disp + f * vr * vc * 2;
            float* map_x = out_maps + f * 2 * rh * rw;
            float* map_y = map_x + rh * rw;
            rasterize_maps(du, ds, height, width, mesh_rows, mesh_cols,
                           rx0, rx1, ry0, ry1, hinv.data(), map_x, map_y,
                           nullptr);
        }
    });
}

// Crop [left, top, right, bottom] (inclusive) and bilinear-stretch back to
// (W, H) with cv2.resize half-pixel semantics and edge clamping.
extern "C" void mf_crop_resize(
    const uint8_t* frames, long num_frames, long height, long width,
    int32_t left, int32_t top, int32_t right, int32_t bottom,
    uint8_t* out_frames) {
    const double crop_w = right - left + 1;
    const double crop_h = bottom - top + 1;
    const double sx = crop_w / width;
    const double sy = crop_h / height;

    std::vector<long> xi(width), x1t(width), yi(height);
    std::vector<float> xf(width), yf(height);
    for (long x = 0; x < width; ++x) {
        double v = (x + 0.5) * sx - 0.5;
        v = std::min(std::max(v, 0.0), crop_w - 1.0) + left;
        long g = (long)std::floor(v);
        xi[x] = g;
        x1t[x] = std::min<long>(g + 1, width - 1);
        xf[x] = (float)(v - g);
    }
    for (long y = 0; y < height; ++y) {
        double v = (y + 0.5) * sy - 0.5;
        v = std::min(std::max(v, 0.0), crop_h - 1.0) + top;
        long g = (long)std::floor(v);
        yi[y] = g;
        yf[y] = (float)(v - g);
    }

    parallel_for(num_frames, [&](long f0, long f1) {
        for (long f = f0; f < f1; ++f) {
            const uint8_t* src = frames + f * height * width * 3;
            uint8_t* dst = out_frames + f * height * width * 3;
            for (long y = 0; y < height; ++y) {
                long y0 = yi[y];
                long y1 = std::min<long>(y0 + 1, height - 1);
                stretch_row(src, width, xi.data(), x1t.data(), xf.data(),
                            y0, y1, yf[y], width, dst + y * width * 3);
            }
        }
    });
}
