// Weighted grid A* — native planner core for ros2_mpc_jax.
//
// The reference delegates its live global planning to the pyastar2d C++
// extension (ros2_mpc/planner/global_planner.py:91-93): a weighted-grid A*
// over float32 cell weights (>= 1), 4- or 8-neighborhood, returning the full
// start->goal cell path. This is an independent implementation of the same
// contract with a binary-heap open list, exposed through a C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC astar.cpp -o libastar.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct HeapNode {
  float f;
  int idx;
};

struct HeapCmp {
  bool operator()(const HeapNode& a, const HeapNode& b) const { return a.f > b.f; }
};

}  // namespace

extern "C" {

// Returns the number of path points written to out_path (as row,col pairs,
// start first), or 0 if no path exists / inputs are invalid. out_path must
// have capacity 2*h*w ints.
int astar_path(const float* weights, int h, int w, int start_r, int start_c,
               int goal_r, int goal_c, int allow_diagonal, int* out_path) {
  if (h <= 0 || w <= 0) return 0;
  if (start_r < 0 || start_r >= h || start_c < 0 || start_c >= w) return 0;
  if (goal_r < 0 || goal_r >= h || goal_c < 0 || goal_c >= w) return 0;

  const int n = h * w;
  const int start = start_r * w + start_c;
  const int goal = goal_r * w + goal_c;

  std::vector<float> g(n, INFINITY);
  std::vector<int> parent(n, -1);
  std::vector<uint8_t> closed(n, 0);

  auto heuristic = [&](int idx) -> float {
    const int r = idx / w, c = idx % w;
    const float dr = static_cast<float>(std::abs(r - goal_r));
    const float dc = static_cast<float>(std::abs(c - goal_c));
    if (allow_diagonal) {
      // Octile distance (admissible with unit minimum weight).
      const float mn = dr < dc ? dr : dc;
      const float mx = dr < dc ? dc : dr;
      return mx + 0.41421356f * mn;
    }
    return dr + dc;  // Manhattan
  };

  std::priority_queue<HeapNode, std::vector<HeapNode>, HeapCmp> open;
  g[start] = 0.0f;
  open.push({heuristic(start), start});

  const int dr4[4] = {-1, 1, 0, 0};
  const int dc4[4] = {0, 0, -1, 1};
  const int dr8[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
  const int dc8[8] = {0, 0, -1, 1, -1, 1, -1, 1};
  const int* drs = allow_diagonal ? dr8 : dr4;
  const int* dcs = allow_diagonal ? dc8 : dc4;
  const int n_nbrs = allow_diagonal ? 8 : 4;

  bool found = false;
  while (!open.empty()) {
    const HeapNode top = open.top();
    open.pop();
    const int cur = top.idx;
    if (closed[cur]) continue;
    closed[cur] = 1;
    if (cur == goal) {
      found = true;
      break;
    }
    const int r = cur / w, c = cur % w;
    for (int k = 0; k < n_nbrs; ++k) {
      const int nr = r + drs[k], nc = c + dcs[k];
      if (nr < 0 || nr >= h || nc < 0 || nc >= w) continue;
      const int nb = nr * w + nc;
      if (closed[nb]) continue;
      const float ng = g[cur] + weights[nb];
      if (ng < g[nb]) {
        g[nb] = ng;
        parent[nb] = cur;
        open.push({ng + heuristic(nb), nb});
      }
    }
  }

  if (!found) return 0;

  // Walk parents goal->start, then reverse into out_path.
  std::vector<int> rev;
  for (int cur = goal; cur != -1; cur = parent[cur]) rev.push_back(cur);
  const int len = static_cast<int>(rev.size());
  for (int i = 0; i < len; ++i) {
    const int idx = rev[len - 1 - i];
    out_path[2 * i] = idx / w;
    out_path[2 * i + 1] = idx % w;
  }
  return len;
}

}  // extern "C"
