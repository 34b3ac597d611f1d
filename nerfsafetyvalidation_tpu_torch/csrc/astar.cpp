// A* over a 3-D occupancy grid, host code bound with ctypes (nav/astar.py).
//
// 6-connected grid, unit edge cost, euclidean heuristic (the reference's
// nav/quad_helpers.py:201-258). Among paths of equal cost the one returned
// depends on the heap's order and on the heuristic's rounding, so this
// file is built with the flags of the JAX package's native library
// (g++ -O3 -march=native) and compared path for path with it.

#include <cmath>
#include <cstdint>
#include <functional>
#include <limits>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

// Returns the path's length in cells, written to out_path as xyz triples;
// -1 when the goal is unreachable (or start or goal is occupied), -2 when
// the path is longer than max_path.
int64_t astar3d(const uint8_t* occupied, int32_t sx, int32_t sy, int32_t sz,
                const int32_t* start, const int32_t* goal, int32_t* out_path,
                int64_t max_path) {
  const int64_t n = (int64_t)sx * sy * sz;
  auto idx = [&](int32_t x, int32_t y, int32_t z) -> int64_t {
    return ((int64_t)x * sy + y) * sz + z;
  };
  const int64_t start_i = idx(start[0], start[1], start[2]);
  const int64_t goal_i = idx(goal[0], goal[1], goal[2]);
  if (occupied[start_i] || occupied[goal_i]) return -1;

  auto heuristic = [&](int64_t i) {
    int32_t x = (int32_t)(i / ((int64_t)sy * sz));
    int32_t y = (int32_t)((i / sz) % sy);
    int32_t z = (int32_t)(i % sz);
    double dx = x - goal[0], dy = y - goal[1], dz = z - goal[2];
    return std::sqrt(dx * dx + dy * dy + dz * dz);
  };

  std::vector<float> gscore(n, std::numeric_limits<float>::infinity());
  std::vector<int64_t> came_from(n, -1);
  using Node = std::pair<double, int64_t>;
  std::priority_queue<Node, std::vector<Node>, std::greater<Node>> open;
  gscore[start_i] = 0.f;
  open.push({heuristic(start_i), start_i});

  const int32_t nb[6][3] = {{1, 0, 0}, {-1, 0, 0}, {0, 1, 0},
                            {0, -1, 0}, {0, 0, 1}, {0, 0, -1}};
  while (!open.empty()) {
    auto [f, cur] = open.top();
    open.pop();
    if (cur == goal_i) {
      std::vector<int64_t> rev;
      for (int64_t c = cur; c != -1; c = came_from[c]) rev.push_back(c);
      int64_t len = (int64_t)rev.size();
      if (len > max_path) return -2;
      for (int64_t k = 0; k < len; ++k) {
        int64_t c = rev[len - 1 - k];
        out_path[k * 3 + 0] = (int32_t)(c / ((int64_t)sy * sz));
        out_path[k * 3 + 1] = (int32_t)((c / sz) % sy);
        out_path[k * 3 + 2] = (int32_t)(c % sz);
      }
      return len;
    }
    int32_t x = (int32_t)(cur / ((int64_t)sy * sz));
    int32_t y = (int32_t)((cur / sz) % sy);
    int32_t z = (int32_t)(cur % sz);
    float g = gscore[cur];
    for (auto& d : nb) {
      int32_t nx = x + d[0], ny = y + d[1], nz = z + d[2];
      if (nx < 0 || nx >= sx || ny < 0 || ny >= sy || nz < 0 || nz >= sz)
        continue;
      int64_t ni = idx(nx, ny, nz);
      if (occupied[ni]) continue;
      float tentative = g + 1.0f;
      if (tentative < gscore[ni]) {
        gscore[ni] = tentative;
        came_from[ni] = cur;
        open.push({tentative + heuristic(ni), ni});
      }
    }
  }
  return -1;
}

}  // extern "C"
