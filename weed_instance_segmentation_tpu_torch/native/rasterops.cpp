// Host-side raster ops for the data pipeline: connected-component labeling,
// polygon rasterization and exact RGB colour matching.
//
// Copied by value from weed_instance_segmentation_tpu/native/rasterops.cpp,
// so both packages label and fill the same pixels. They take the role OpenCV
// plays in the reference loaders (cv2.connectedComponents, cv2.fillPoly).
//
// Built by ops/rasterize.py with g++ on first use into the package's build/
// directory and bound with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>
#include <cmath>
#include <algorithm>

namespace {

// Union-find with path halving.
struct UnionFind {
    std::vector<int32_t> parent;
    explicit UnionFind(size_t n) : parent(n) {
        for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
    }
    int32_t find(int32_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    }
    void unite(int32_t a, int32_t b) {
        a = find(a);
        b = find(b);
        if (a == b) return;
        if (a < b) parent[b] = a; else parent[a] = b;
    }
};

}  // namespace

extern "C" {

// 8-connectivity connected components of a binary uint8 mask.
// labels: int32 h*w output, 0 = background, components numbered 1..N in
// row-major order of first occurrence (cv2.connectedComponents convention).
// Returns N + 1 (number of labels including background), like cv2.
int32_t wistpu_connected_components(const uint8_t* mask, int32_t h, int32_t w,
                                    int32_t* labels) {
    const int64_t n = static_cast<int64_t>(h) * w;
    std::vector<int32_t> provisional(n, 0);
    UnionFind uf(n / 2 + 2);  // at most ceil(n/2)+1 provisional labels in 8-conn
    int32_t next = 1;

    // First pass: assign provisional labels, record equivalences.
    for (int32_t y = 0; y < h; ++y) {
        for (int32_t x = 0; x < w; ++x) {
            const int64_t idx = static_cast<int64_t>(y) * w + x;
            if (!mask[idx]) continue;
            int32_t neigh[4];
            int nn = 0;
            if (x > 0 && provisional[idx - 1]) neigh[nn++] = provisional[idx - 1];
            if (y > 0) {
                const int64_t up = idx - w;
                if (provisional[up]) neigh[nn++] = provisional[up];
                if (x > 0 && provisional[up - 1]) neigh[nn++] = provisional[up - 1];
                if (x + 1 < w && provisional[up + 1]) neigh[nn++] = provisional[up + 1];
            }
            if (nn == 0) {
                provisional[idx] = next++;
            } else {
                int32_t m = neigh[0];
                for (int k = 1; k < nn; ++k) m = std::min(m, neigh[k]);
                provisional[idx] = m;
                for (int k = 0; k < nn; ++k) uf.unite(m, neigh[k]);
            }
        }
    }

    // Second pass: flatten equivalences, renumber roots in row-major
    // first-occurrence order.
    std::vector<int32_t> remap(next, 0);
    int32_t count = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (!provisional[i]) {
            labels[i] = 0;
            continue;
        }
        const int32_t root = uf.find(provisional[i]);
        if (remap[root] == 0) remap[root] = ++count;
        labels[i] = remap[root];
    }
    return count + 1;
}

// Scanline polygon fill with even-odd rule plus rasterized boundary,
// approximating cv2.fillPoly (interior + outline pixels).
// pts: n_pts (x, y) int32 pairs. canvas: int32 h*w, filled in place.
void wistpu_fill_poly(int32_t* canvas, int32_t h, int32_t w,
                      const int32_t* pts, int32_t n_pts, int32_t value) {
    if (n_pts < 1) return;

    auto put = [&](int32_t x, int32_t y) {
        if (x >= 0 && x < w && y >= 0 && y < h)
            canvas[static_cast<int64_t>(y) * w + x] = value;
    };

    // Boundary via Bresenham (cv2 includes polygon edges).
    for (int32_t i = 0; i < n_pts; ++i) {
        int32_t x0 = pts[2 * i], y0 = pts[2 * i + 1];
        const int32_t j = (i + 1) % n_pts;
        const int32_t x1 = pts[2 * j], y1 = pts[2 * j + 1];
        const int32_t dx = std::abs(x1 - x0), dy = -std::abs(y1 - y0);
        const int32_t sx = x0 < x1 ? 1 : -1, sy = y0 < y1 ? 1 : -1;
        int32_t err = dx + dy;
        while (true) {
            put(x0, y0);
            if (x0 == x1 && y0 == y1) break;
            const int32_t e2 = 2 * err;
            if (e2 >= dy) { err += dy; x0 += sx; }
            if (e2 <= dx) { err += dx; y0 += sy; }
        }
    }
    if (n_pts < 3) return;

    // Interior via even-odd scanline at integer rows.
    int32_t ymin = pts[1], ymax = pts[1];
    for (int32_t i = 1; i < n_pts; ++i) {
        ymin = std::min(ymin, pts[2 * i + 1]);
        ymax = std::max(ymax, pts[2 * i + 1]);
    }
    ymin = std::max(ymin, 0);
    ymax = std::min(ymax, h - 1);

    std::vector<double> xs;
    for (int32_t y = ymin; y <= ymax; ++y) {
        xs.clear();
        for (int32_t i = 0; i < n_pts; ++i) {
            const int32_t j = (i + 1) % n_pts;
            const double y0 = pts[2 * i + 1], y1 = pts[2 * j + 1];
            const double x0 = pts[2 * i], x1 = pts[2 * j];
            // Half-open rule [min(y0,y1), max(y0,y1)) avoids double-counting
            // vertices.
            if ((y0 <= y && y1 > y) || (y1 <= y && y0 > y)) {
                xs.push_back(x0 + (y - y0) / (y1 - y0) * (x1 - x0));
            }
        }
        std::sort(xs.begin(), xs.end());
        for (size_t k = 0; k + 1 < xs.size(); k += 2) {
            int32_t xa = static_cast<int32_t>(std::ceil(xs[k]));
            int32_t xb = static_cast<int32_t>(std::floor(xs[k + 1]));
            xa = std::max(xa, 0);
            xb = std::min(xb, w - 1);
            for (int32_t x = xa; x <= xb; ++x)
                canvas[static_cast<int64_t>(y) * w + x] = value;
        }
    }
}

// Exact RGB color match: out[i] = 1 where rgb pixel equals (r,g,b).
// Mirrors np.all(mask_rgb == color, axis=-1) in the crop_weed PNG loader.
void wistpu_color_match(const uint8_t* rgb, int32_t h, int32_t w,
                        uint8_t r, uint8_t g, uint8_t b, uint8_t* out) {
    const int64_t n = static_cast<int64_t>(h) * w;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* p = rgb + 3 * i;
        out[i] = (p[0] == r && p[1] == g && p[2] == b) ? 1 : 0;
    }
}

}  // extern "C"
