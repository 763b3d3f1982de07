// Greedy graph coloring for sparse-Jacobian compression (host code, C++).
//
// The port's own copy of the JAX package's native colorer (reference
// crates/diffsol/src/jacobian/coloring.rs `nonzeros2graph` and
// greedy_coloring.rs `color_graph_greedy`): columns of the Jacobian that
// share a nonzero row are connected, and a greedy first-fit coloring in
// natural column order groups structurally orthogonal columns, so each
// color needs one JVP probe.  It runs once at problem set-up on the host;
// the solve consumes only the color vector.  Built with g++ by
// diffsol_tpu_torch/_build.py and bound with ctypes
// (diffsol_tpu_torch/ops/coloring.py), whose pure-Python greedy is its
// plain version.

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

extern "C" {

// Inputs: nnz nonzeros of an n_rows x n_cols pattern as (rows[k], cols[k]).
// Output: colors[n_cols] (0-based); returns the number of colors used, or
// -1 on invalid input.
int64_t diffsol_greedy_color(const int64_t* rows, const int64_t* cols, int64_t nnz,
                             int64_t n_rows, int64_t n_cols, int64_t* colors) {
  if (n_cols <= 0 || n_rows < 0 || nnz < 0) return -1;

  // row -> the columns with a nonzero in it, and column -> its rows
  std::vector<std::vector<int64_t>> row_cols(static_cast<size_t>(n_rows));
  std::vector<std::vector<int64_t>> col_rows(static_cast<size_t>(n_cols));
  for (int64_t k = 0; k < nnz; ++k) {
    const int64_t r = rows[k], c = cols[k];
    if (r < 0 || r >= n_rows || c < 0 || c >= n_cols) return -1;
    row_cols[static_cast<size_t>(r)].push_back(c);
    col_rows[static_cast<size_t>(c)].push_back(r);
  }

  // first fit in natural column order: a column takes the least color no
  // column sharing one of its rows holds (the conflict graph is walked in
  // place, never stored: a dense pattern's would hold n^3 entries)
  std::vector<char> used;
  int64_t ncolors = 0;
  for (int64_t c = 0; c < n_cols; ++c) colors[c] = -1;
  for (int64_t c = 0; c < n_cols; ++c) {
    used.assign(static_cast<size_t>(ncolors) + 1, 0);
    for (const int64_t r : col_rows[static_cast<size_t>(c)]) {
      for (const int64_t nb : row_cols[static_cast<size_t>(r)]) {
        const int64_t nc = colors[nb];
        if (nc >= 0) used[static_cast<size_t>(nc)] = 1;
      }
    }
    int64_t pick = 0;
    while (used[static_cast<size_t>(pick)]) ++pick;
    colors[c] = pick;
    if (pick + 1 > ncolors) ncolors = pick + 1;
  }
  return ncolors;
}

}  // extern "C"
