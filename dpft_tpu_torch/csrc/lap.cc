// Rectangular linear sum assignment (Jonker-Volgenant / Crouse 2016).
//
// Host-side solver for Hungarian matching, the role scipy's C++
// linear_sum_assignment plays for the reference (assigner.py:138); own copy
// of native/lap.cc. dpft_tpu_torch/ops/hungarian.py solves the training
// path's matching with it. Exposed with a C ABI for ctypes.
//
// Build (dpft_tpu_torch/ops/lap_native.py does it at first use):
//   g++ -O2 -shared -fPIC -o liblap.so lap.cc

#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// Augments the assignment with a shortest alternating path from cur_row.
// Returns the sink column, or -1 if the problem is infeasible.
int augmenting_path(int nr, int nc, const double* cost, std::vector<double>& u,
                    std::vector<double>& v, std::vector<int>& path,
                    std::vector<int>& row4col,
                    std::vector<double>& shortest_path_costs, int cur_row,
                    std::vector<bool>& SR, std::vector<bool>& SC,
                    double* p_min_val) {
  double min_val = 0;
  int num_remaining = nc;
  std::vector<int> remaining(nc);
  for (int it = 0; it < nc; ++it) remaining[it] = nc - it - 1;

  std::fill(SR.begin(), SR.end(), false);
  std::fill(SC.begin(), SC.end(), false);
  std::fill(shortest_path_costs.begin(), shortest_path_costs.end(), kInf);

  int sink = -1;
  int i = cur_row;
  while (sink == -1) {
    int index = -1;
    double lowest = kInf;
    SR[i] = true;

    for (int it = 0; it < num_remaining; ++it) {
      int j = remaining[it];
      double r = min_val + cost[i * nc + j] - u[i] - v[j];
      if (r < shortest_path_costs[j]) {
        path[j] = i;
        shortest_path_costs[j] = r;
      }
      if (shortest_path_costs[j] < lowest ||
          (shortest_path_costs[j] == lowest && row4col[j] == -1)) {
        lowest = shortest_path_costs[j];
        index = it;
      }
    }

    min_val = lowest;
    if (min_val == kInf) return -1;  // infeasible

    int j = remaining[index];
    if (row4col[j] == -1) {
      sink = j;
    } else {
      i = row4col[j];
    }
    SC[j] = true;
    remaining[index] = remaining[--num_remaining];
  }

  *p_min_val = min_val;
  return sink;
}

}  // namespace

extern "C" {

// Solves min-cost assignment for an (nr x nc) row-major cost matrix with
// nr <= nc. Writes the assigned column per row into col4row (nr entries).
// Returns 0 on success, -1 on infeasibility / invalid input.
int lap_solve(int nr, int nc, const double* cost, int* col4row_out) {
  if (nr > nc || nr < 0) return -1;

  std::vector<double> u(nr, 0), v(nc, 0), shortest_path_costs(nc);
  std::vector<int> path(nc, -1), col4row(nr, -1), row4col(nc, -1);
  std::vector<bool> SR(nr), SC(nc);

  for (int cur_row = 0; cur_row < nr; ++cur_row) {
    double min_val;
    int sink = augmenting_path(nr, nc, cost, u, v, path, row4col,
                               shortest_path_costs, cur_row, SR, SC,
                               &min_val);
    if (sink < 0) return -1;

    u[cur_row] += min_val;
    for (int i = 0; i < nr; ++i) {
      if (SR[i] && i != cur_row) {
        u[i] += min_val - shortest_path_costs[col4row[i]];
      }
    }
    for (int j = 0; j < nc; ++j) {
      if (SC[j]) v[j] -= min_val - shortest_path_costs[j];
    }

    int j = sink;
    while (true) {
      int i = path[j];
      row4col[j] = i;
      int tmp = col4row[i];
      col4row[i] = j;
      j = tmp;
      if (i == cur_row) break;
    }
  }

  for (int i = 0; i < nr; ++i) col4row_out[i] = col4row[i];
  return 0;
}

// Batched variant: costs is (batch, nr, nc), out is (batch, nr).
int lap_solve_batch(int batch, int nr, int nc, const double* costs,
                    int* col4row_out) {
  for (int b = 0; b < batch; ++b) {
    int rc = lap_solve(nr, nc, costs + (int64_t)b * nr * nc,
                       col4row_out + (int64_t)b * nr);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
