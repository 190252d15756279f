// Native host runtime: dataset reading, graph transforms, and static-shape
// bucket packing.
//
// The port's copy of flowgnn_tpu/runtime/packer.cc, the counterpart of the
// reference's host-side data path (graph fetch + packed-array append,
// GIN/src/host_load.cc:100-143 and GIN/src/host.cc:119-138) plus the
// host-side augmentations (GIN-VN virtual node,
// GIN-VN/src/host_load.cc:129-153; GAT self edges,
// GAT/src/load_inputs.cc:144-149). The packer produces exactly the
// PackedGraphs layout of flowgnn_tpu_torch/core/graphs.py: flat node/edge
// arrays with one trailing pad node and pad graph, byte for byte what the
// numpy packer builds (tests/test_torch_runtime.py).
//
// Exposed as a plain C ABI for ctypes (runtime/native.py), which releases
// the GIL for each call, so the stream's worker threads pack in parallel.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kAtomFeatures = 9;
constexpr int kBondFeatures = 3;

struct GraphView {
  const int32_t* node_feat;  // [n, 9]
  const int32_t* edge_index; // [e, 2]
  const int32_t* edge_attr;  // [e, 3] or nullptr
  int32_t n;
  int32_t e;
};

}  // namespace

extern "C" {

// Pack a run of graphs (concatenated arrays + per-graph counts) into one
// fixed-capacity bucket. Returns the number of graphs consumed (those that
// fit), or -1 if the first graph alone exceeds capacity. Output arrays must
// be pre-allocated by the caller with the PackedGraphs shapes:
//   out_node_feat [node_cap+1, 9]   out_node_graph [node_cap+1]
//   out_senders/out_receivers [edge_cap]   out_edge_attr [edge_cap, 3]
//   out_n_node/out_n_edge [graph_cap+1]
int32_t fg_pack_bucket(
    const int32_t* node_feat, const int32_t* edge_index,
    const int32_t* edge_attr,  // nullable
    const int32_t* n_nodes, const int32_t* n_edges, int32_t num_graphs,
    int32_t node_cap, int32_t edge_cap, int32_t graph_cap,
    int32_t* out_node_feat, int32_t* out_node_graph, int32_t* out_senders,
    int32_t* out_receivers, int32_t* out_edge_attr, int32_t* out_n_node,
    int32_t* out_n_edge) {
  // Initialise padding: zero features, pad-graph ids, pad-node edge targets.
  std::memset(out_node_feat, 0, sizeof(int32_t) * (node_cap + 1) * kAtomFeatures);
  std::memset(out_edge_attr, 0, sizeof(int32_t) * edge_cap * kBondFeatures);
  std::memset(out_n_node, 0, sizeof(int32_t) * (graph_cap + 1));
  std::memset(out_n_edge, 0, sizeof(int32_t) * (graph_cap + 1));
  for (int32_t i = 0; i <= node_cap; ++i) out_node_graph[i] = graph_cap;
  for (int32_t i = 0; i < edge_cap; ++i) {
    out_senders[i] = node_cap;
    out_receivers[i] = node_cap;
  }

  int32_t node_off = 0, edge_off = 0, g = 0;
  int64_t in_node_off = 0, in_edge_off = 0;
  for (; g < num_graphs && g < graph_cap; ++g) {
    const int32_t n = n_nodes[g], e = n_edges[g];
    if (node_off + n > node_cap || edge_off + e > edge_cap) break;
    std::memcpy(out_node_feat + (int64_t)node_off * kAtomFeatures,
                node_feat + in_node_off * kAtomFeatures,
                sizeof(int32_t) * n * kAtomFeatures);
    for (int32_t i = 0; i < n; ++i) out_node_graph[node_off + i] = g;
    const int32_t* ei = edge_index + in_edge_off * 2;
    for (int32_t i = 0; i < e; ++i) {
      out_senders[edge_off + i] = ei[2 * i] + node_off;
      out_receivers[edge_off + i] = ei[2 * i + 1] + node_off;
    }
    if (edge_attr != nullptr) {
      std::memcpy(out_edge_attr + (int64_t)edge_off * kBondFeatures,
                  edge_attr + in_edge_off * kBondFeatures,
                  sizeof(int32_t) * e * kBondFeatures);
    }
    out_n_node[g] = n;
    out_n_edge[g] = e;
    node_off += n;
    edge_off += e;
    in_node_off += n;
    in_edge_off += e;
  }
  if (g == 0) return -1;
  out_n_node[graph_cap] = node_cap + 1 - node_off;
  out_n_edge[graph_cap] = edge_cap - edge_off;
  return g;
}

// Window-ALIGNED bucket packing (the fast path of core/graphs.py's
// pack_graphs_aligned): identical to fg_pack_bucket except a graph that
// fits one window never straddles a window boundary (it advances to the
// next boundary first), leaving gap rows as pad nodes owned by the pad
// graph. This is the locality contract of the graph-local kernels; in the
// pipelined host application (runtime/stream.py) this pack runs on worker
// threads in the device's shadow, as the reference loads graphs inside
// every timed pass (GIN/src/load_inputs.cc:87-172).
int32_t fg_pack_bucket_aligned(
    const int32_t* node_feat, const int32_t* edge_index,
    const int32_t* edge_attr,  // nullable
    const int32_t* n_nodes, const int32_t* n_edges, int32_t num_graphs,
    int32_t node_cap, int32_t edge_cap, int32_t graph_cap, int32_t window,
    int32_t* out_node_feat, int32_t* out_node_graph, int32_t* out_senders,
    int32_t* out_receivers, int32_t* out_edge_attr, int32_t* out_n_node,
    int32_t* out_n_edge) {
  std::memset(out_node_feat, 0,
              sizeof(int32_t) * (int64_t)(node_cap + 1) * kAtomFeatures);
  std::memset(out_edge_attr, 0,
              sizeof(int32_t) * (int64_t)edge_cap * kBondFeatures);
  std::memset(out_n_node, 0, sizeof(int32_t) * (graph_cap + 1));
  std::memset(out_n_edge, 0, sizeof(int32_t) * (graph_cap + 1));
  for (int32_t i = 0; i <= node_cap; ++i) out_node_graph[i] = graph_cap;
  for (int32_t i = 0; i < edge_cap; ++i) {
    out_senders[i] = node_cap;
    out_receivers[i] = node_cap;
  }

  int32_t off = 0, edge_off = 0, g = 0, real_nodes = 0;
  int64_t in_node_off = 0, in_edge_off = 0;
  for (; g < num_graphs && g < graph_cap; ++g) {
    const int32_t n = n_nodes[g], e = n_edges[g];
    int32_t node_off = off;
    if (window > 0 && n <= window) {
      const int32_t room = window - (node_off % window);
      if (n > room) node_off += room;
    }
    if (node_off + n > node_cap || edge_off + e > edge_cap) break;
    std::memcpy(out_node_feat + (int64_t)node_off * kAtomFeatures,
                node_feat + in_node_off * kAtomFeatures,
                sizeof(int32_t) * n * kAtomFeatures);
    for (int32_t i = 0; i < n; ++i) out_node_graph[node_off + i] = g;
    const int32_t* ei = edge_index + in_edge_off * 2;
    for (int32_t i = 0; i < e; ++i) {
      out_senders[edge_off + i] = ei[2 * i] + node_off;
      out_receivers[edge_off + i] = ei[2 * i + 1] + node_off;
    }
    if (edge_attr != nullptr) {
      std::memcpy(out_edge_attr + (int64_t)edge_off * kBondFeatures,
                  edge_attr + in_edge_off * kBondFeatures,
                  sizeof(int32_t) * e * kBondFeatures);
    }
    out_n_node[g] = n;
    out_n_edge[g] = e;
    off = node_off + n;
    real_nodes += n;
    edge_off += e;
    in_node_off += n;
    in_edge_off += e;
  }
  if (g == 0) return -1;
  out_n_node[graph_cap] = node_cap + 1 - real_nodes;
  out_n_edge[graph_cap] = edge_cap - edge_off;
  return g;
}

// Virtual-node augmentation in place of the GIN-VN host
// (GIN-VN/src/host_load.cc:129-153): appends one zero-feature node and the
// bidirectional star of zero-attr edges. Output capacities must be at least
// n+1 nodes and e+2n edges.
void fg_add_virtual_node(const int32_t* node_feat, const int32_t* edge_index,
                         const int32_t* edge_attr, int32_t n, int32_t e,
                         int32_t* out_node_feat, int32_t* out_edge_index,
                         int32_t* out_edge_attr) {
  std::memcpy(out_node_feat, node_feat, sizeof(int32_t) * n * kAtomFeatures);
  std::memset(out_node_feat + (int64_t)n * kAtomFeatures, 0,
              sizeof(int32_t) * kAtomFeatures);
  std::memcpy(out_edge_index, edge_index, sizeof(int32_t) * e * 2);
  for (int32_t nd = 0; nd < n; ++nd) {
    out_edge_index[2 * (e + 2 * nd)] = nd;
    out_edge_index[2 * (e + 2 * nd) + 1] = n;
    out_edge_index[2 * (e + 2 * nd + 1)] = n;
    out_edge_index[2 * (e + 2 * nd + 1) + 1] = nd;
  }
  if (edge_attr != nullptr) {
    std::memcpy(out_edge_attr, edge_attr, sizeof(int32_t) * e * kBondFeatures);
    std::memset(out_edge_attr + (int64_t)e * kBondFeatures, 0,
                sizeof(int32_t) * 2 * n * kBondFeatures);
  }
}

// Self-loop augmentation (GAT/src/load_inputs.cc:144-149): self edges first.
void fg_add_self_loops(const int32_t* edge_index, int32_t n, int32_t e,
                       int32_t* out_edge_index) {
  for (int32_t nd = 0; nd < n; ++nd) {
    out_edge_index[2 * nd] = nd;
    out_edge_index[2 * nd + 1] = nd;
  }
  std::memcpy(out_edge_index + (int64_t)n * 2, edge_index,
              sizeof(int32_t) * e * 2);
}

// Graph-local ELL layout (core/blocking.py:build_local_blocks_ell, C++ fast
// path — the pack-time analog of the reference building its dest%4 PE
// stripes while loading, GIN/src/load_inputs.cc:87-172). Semantics match
// the NumPy builder exactly (tests/test_torch_runtime.py holds them equal):
//   * edges whose endpoints share a `window`-row node block are dealt to
//     that window's k_blocks*block ELL lanes, receiver-stable order;
//   * window-crossing edges (ascending edge index), then per-window ELL
//     overflow (receiver-stable), go to the spill list;
//   * k_blocks < 0 auto-sizes from the 95th percentile of per-window edge
//     counts (np.percentile 'linear' interpolation), clamped to [1, 4].
// Outputs: u_local/v_local/edge_perm [NW*K*B] (sentinel `window`, perm 0),
// valid [NW*K*B] (0/1), spill [<= e]. Returns the spill count, or -1 (and
// writes nothing) if a sender or receiver lies outside [0, num_nodes);
// *io_k_blocks receives the k actually used. Caller sizes the lane arrays
// after a first call with null outputs (probe mode: only *io_k_blocks is
// written).
int32_t fg_build_local_ell(const int32_t* senders, const int32_t* receivers,
                           int64_t e, int32_t num_nodes, int32_t window,
                           int32_t block, int32_t* io_k_blocks,
                           int32_t* u_local, int32_t* v_local,
                           int32_t* edge_perm, int32_t* valid,
                           int32_t* spill) {
  for (int64_t i = 0; i < e; ++i) {
    if (senders[i] < 0 || senders[i] >= num_nodes || receivers[i] < 0 ||
        receivers[i] >= num_nodes)
      return -1;
  }
  const int32_t num_windows = (num_nodes + window - 1) / window;
  // Receiver-stable order of local edges via counting sort by receiver.
  std::vector<int32_t> win_count(num_windows, 0);
  std::vector<int64_t> recv_count(num_nodes + 1, 0);
  const int32_t pad = num_nodes - 1;
  auto is_local = [&](int64_t i) {
    return receivers[i] < pad && senders[i] / window == receivers[i] / window;
  };
  for (int64_t i = 0; i < e; ++i) {
    if (is_local(i)) {
      ++win_count[receivers[i] / window];
      ++recv_count[receivers[i]];
    }
  }

  if (*io_k_blocks < 0) {
    // np.percentile(counts, 95, interpolation='linear') over window counts.
    std::vector<int32_t> sorted(win_count);
    std::sort(sorted.begin(), sorted.end());
    double p95 = 0.0;
    if (!sorted.empty()) {
      const double pos = 0.95 * (double)(sorted.size() - 1);
      const size_t lo = (size_t)pos;
      const double frac = pos - (double)lo;
      p95 = sorted[lo] +
            frac * ((lo + 1 < sorted.size() ? sorted[lo + 1] : sorted[lo]) -
                    sorted[lo]);
    }
    int64_t k = (int64_t)(-std::floor(-p95 / block));
    if (k < 1) k = 1;
    if (k > 4) k = 4;
    *io_k_blocks = (int32_t)k;
  }
  if (u_local == nullptr) return 0;  // probe call: k_blocks only

  const int32_t k_blocks = *io_k_blocks;
  const int64_t cap = (int64_t)k_blocks * block;
  const int64_t p = (int64_t)num_windows * cap;
  for (int64_t i = 0; i < p; ++i) {
    u_local[i] = window;
    v_local[i] = window;
    edge_perm[i] = 0;
    valid[i] = 0;
  }

  // Prefix sums → receiver-stable scatter of local edge indices.
  int64_t acc = 0;
  for (int32_t r = 0; r <= num_nodes; ++r) {
    const int64_t c = recv_count[r];
    recv_count[r] = acc;
    acc += c;
  }
  std::vector<int32_t> order((size_t)acc);
  for (int64_t i = 0; i < e; ++i) {
    if (is_local(i)) order[recv_count[receivers[i]]++] = (int32_t)i;
  }

  int32_t n_spill = 0;
  for (int64_t i = 0; i < e; ++i) {  // crossing edges, ascending index
    if (receivers[i] < pad && !is_local(i)) spill[n_spill++] = (int32_t)i;
  }
  int64_t pos = 0;
  for (int32_t w = 0; w < num_windows; ++w) {
    const int64_t cnt = win_count[w];
    const int64_t take = cnt < cap ? cnt : cap;
    const int64_t base = (int64_t)w * cap;
    for (int64_t j = 0; j < take; ++j) {
      const int32_t idx = order[pos + j];
      u_local[base + j] = senders[idx] - w * window;
      v_local[base + j] = receivers[idx] - w * window;
      edge_perm[base + j] = idx;
      valid[base + j] = 1;
    }
    for (int64_t j = take; j < cnt; ++j) spill[n_spill++] = order[pos + j];
    pos += cnt;
  }
  return n_spill;
}

// Read one reference-layout graph (g%d_info.txt + g%d_*.bin,
// GIN/src/host.cc:126-137). Two-phase: call with null outputs to get counts,
// then with allocated buffers. Returns 0 on success.
int32_t fg_read_graph(const char* dataset_dir, int32_t index,
                      int32_t* out_counts,  // [2] = n, e
                      int32_t* node_feat, int32_t* edge_index,
                      int32_t* edge_attr) {
  char path[1024];
  std::snprintf(path, sizeof(path), "%s/graph_info/g%d_info.txt", dataset_dir,
                index);
  FILE* f = std::fopen(path, "r");
  if (!f) return 1;
  int n = 0, e = 0;
  if (std::fscanf(f, "%d%d", &n, &e) != 2) {
    std::fclose(f);
    return 2;
  }
  std::fclose(f);
  out_counts[0] = n;
  out_counts[1] = e;
  if (node_feat == nullptr) return 0;

  auto read_bin = [&](const char* suffix, int32_t* dst, size_t count) {
    std::snprintf(path, sizeof(path), "%s/graph_bin/g%d_%s.bin", dataset_dir,
                  index, suffix);
    FILE* bf = std::fopen(path, "rb");
    if (!bf) return false;
    const size_t got = std::fread(dst, sizeof(int32_t), count, bf);
    std::fclose(bf);
    return got == count;
  };
  if (!read_bin("node_feature", node_feat, (size_t)n * kAtomFeatures)) return 3;
  if (!read_bin("edge_list", edge_index, (size_t)e * 2)) return 4;
  if (edge_attr != nullptr &&
      !read_bin("edge_attr", edge_attr, (size_t)e * kBondFeatures))
    return 5;
  return 0;
}

}  // extern "C"
