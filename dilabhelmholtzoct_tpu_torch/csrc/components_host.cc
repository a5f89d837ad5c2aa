// The component engine of prompt extraction, on the host: 8-connected
// component labelling of a class map and the pixel picks of point prompts.
// Built into the port's host library beside persistence_host.cc and loaded
// with ctypes by ops/native.py; the prompt sampling of data/sampling.py runs
// on it.
//
// It counterparts the labelling half of the JAX package's native library
// (native/persistence.cc: label_components_8, extract_components,
// component_pixel_at) with the same contracts, but labels a class map in one
// union-find where that one relabels a binary map per class value: two
// neighbours (8-connectivity) unite when their values are equal, so every
// tree is one component of one class. Each union points the larger root at
// the smaller, so a root is its component's first pixel in raster order, and
// numbering the roots in raster order gives scipy.ndimage.label's order
// (3x3 ones structure).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// The root of x, halving the path on the way.
inline int32_t find_root(int32_t* parent, int32_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];
    x = parent[x];
  }
  return x;
}

inline void unite(int32_t* parent, int32_t a, int32_t b) {
  a = find_root(parent, a);
  b = find_root(parent, b);
  if (a < b)
    parent[b] = a;
  else if (b < a)
    parent[a] = b;
}

// One raster pass: parent[p] for every pixel, in the set of each earlier
// 8-neighbour (W, NW, N, NE) of the same key; pixels with key[p] == skip
// stay out (parent -1). Earlier neighbours that touch each other are in one
// set already (N with NW, NE and W; W with NW), so a pixel joins the set of
// its first equal neighbour in the order N, W, NW, NE and unites with NE
// besides only when it joined W's or NW's. Afterwards parent[p] is p's root,
// the first pixel of its component.
template <class Key>
void union_pass(const Key* key, int h, int w, int skip, int32_t* parent) {
  for (int y = 0; y < h; ++y) {
    const Key* row = key + static_cast<int64_t>(y) * w;
    const Key* up = row - w;
    int32_t* par = parent + static_cast<int64_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      const int k = row[x];
      const int32_t p = y * w + x;
      if (k == skip) {
        par[x] = -1;
        continue;
      }
      const bool n = y > 0 && up[x] == k;
      const bool ne = y > 0 && x + 1 < w && up[x + 1] == k;
      if (n) {
        par[x] = find_root(parent, p - w);
      } else if (x > 0 && row[x - 1] == k) {
        par[x] = find_root(parent, p - 1);
        if (ne) unite(parent, p, p - w + 1);
      } else if (y > 0 && x > 0 && up[x - 1] == k) {
        par[x] = find_root(parent, p - w - 1);
        if (ne) unite(parent, p, p - w + 1);
      } else {
        par[x] = ne ? find_root(parent, p - w + 1) : p;
      }
    }
  }
  // roots precede their pixels: one forward pass flattens every tree
  for (int64_t p = 0; p < static_cast<int64_t>(h) * w; ++p)
    if (parent[p] >= 0) parent[p] = parent[parent[p]];
}

}  // namespace

extern "C" {

// 8-connected components of a (h, w) binary mask (nonzero = foreground):
// labels_out (h, w) int32 gets 1..n in raster order of each component's
// first pixel, 0 off the mask. Returns n.
int32_t label_components_8(const uint8_t* mask, int h, int w,
                           int32_t* labels_out) {
  const int32_t n = h * w;
  std::vector<uint8_t> fg(n);
  for (int32_t p = 0; p < n; ++p) fg[p] = mask[p] != 0;
  union_pass(fg.data(), h, w, /*skip=*/0, labels_out);
  int32_t count = 0;
  for (int32_t p = 0; p < n; ++p) {
    const int32_t r = labels_out[p];
    if (r < 0)
      labels_out[p] = 0;
    else
      labels_out[p] = r == p ? ++count : labels_out[r];
  }
  return count;
}

// The RNG-free half of prompt sampling from a (h, w) uint8 class map: for
// each class value present, ascending, its 8-connected components in raster
// order of their first pixels, slots 1, 2, ... in that order. comp_map (h,
// w) int32 gets each pixel's slot (0 past max_comps); values, bboxes
// (x0, y0, x1, y1 inclusive) and sizes, max_comps entries each, the emitted
// slots' class value, box and pixel count. Returns every component found,
// those past max_comps too.
int32_t extract_components(const uint8_t* label, int h, int w, int max_comps,
                           int32_t* comp_map, int32_t* values,
                           int32_t* bboxes, int32_t* sizes) {
  const int32_t n = h * w;
  std::vector<int32_t> parent(n);
  union_pass(label, h, w, /*skip=*/-1, parent.data());
  // slots by (value, first pixel): count each value's components, then
  // number them in raster order from their value's first slot
  int32_t next[257] = {0};
  for (int32_t p = 0; p < n; ++p)
    if (parent[p] == p) ++next[label[p] + 1];
  for (int v = 0; v < 256; ++v) next[v + 1] += next[v];
  const int32_t total = next[256];
  const int32_t emitted = std::min<int32_t>(total, std::max(max_comps, 0));
  for (int32_t s = 0; s < emitted; ++s) {
    bboxes[4 * s + 0] = w;
    bboxes[4 * s + 1] = h;
    bboxes[4 * s + 2] = -1;
    bboxes[4 * s + 3] = -1;
    sizes[s] = 0;
  }
  // comp_map holds each pixel's slot, 0-based, while the first pass runs
  // (a root is met before the rest of its component), then the slot id
  for (int32_t p = 0; p < n; ++p) {
    const int32_t r = parent[p];
    int32_t s;
    if (r == p) {
      s = next[label[p]]++;
      if (s < emitted) values[s] = label[p];
    } else {
      s = comp_map[r];
    }
    comp_map[p] = s;
  }
  for (int y = 0, p = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x, ++p) {
      const int32_t s = comp_map[p];
      if (s >= emitted) {
        comp_map[p] = 0;
        continue;
      }
      comp_map[p] = s + 1;
      int32_t* bb = bboxes + 4 * s;
      bb[0] = std::min(bb[0], x);
      bb[1] = std::min(bb[1], y);
      bb[2] = std::max(bb[2], x);
      bb[3] = std::max(bb[3], y);
      ++sizes[s];
    }
  }
  return total;
}

// out_xy (n_comps, 2) int32: the (x, y) of the ranks[s]-th pixel, in raster
// order, of slot s + 1 of a (h, w) comp_map, for each s < n_comps (ranks
// within the slot's size). One pass, stopped once every slot is found.
void component_pixel_at(const int32_t* comp_map, int h, int w, int n_comps,
                        const int64_t* ranks, int32_t* out_xy) {
  std::vector<int64_t> left(ranks, ranks + n_comps);
  int remaining = n_comps;
  for (int32_t p = 0; p < h * w && remaining > 0; ++p) {
    const int32_t s = comp_map[p] - 1;
    if (s < 0 || s >= n_comps || left[s]-- != 0) continue;
    out_xy[2 * s + 0] = p % w;
    out_xy[2 * s + 1] = p / w;
    --remaining;
  }
}

}  // extern "C"
