// Dense Jonker-Volgenant linear assignment (square, double costs).
//
// The port's copy of adas_tpu/native/lapjv.cpp: a replacement for the reference's external `lap.lapjv` C++
// dependency (ObjectTracker/byteTrack/matching.py:3,24): ByteTrack's
// association step needs an exact LAP solve with a cost limit; the limit
// handling (matrix extension) lives in the Python wrapper, this file is
// the square solver.
//
// Classic three-phase JV: column reduction, augmenting row reduction,
// then shortest augmenting paths (Dijkstra on reduced costs).
//
// Exported C ABI:
//   int lapjv(int n, const double* cost /* n*n row-major */,
//             int* rowsol /* n */, int* colsol /* n */)
// Returns 0 on success; rowsol[i] = column assigned to row i.

#include <cfloat>
#include <cstdlib>
#include <vector>

extern "C" {

int lapjv(int n, const double* cost, int* rowsol, int* colsol) {
  if (n <= 0) return -1;
  std::vector<double> u(n, 0.0), v(n, 0.0);
  std::vector<int> free_rows(n), collist(n), matches(n, 0);
  std::vector<double> d(n);
  std::vector<int> pred(n);

  for (int i = 0; i < n; ++i) rowsol[i] = -1;
  for (int j = 0; j < n; ++j) colsol[j] = -1;

  // --- Column reduction (scan columns right-to-left). ---
  for (int j = n - 1; j >= 0; --j) {
    double min_c = cost[0 * n + j];
    int imin = 0;
    for (int i = 1; i < n; ++i) {
      double c = cost[i * n + j];
      if (c < min_c) {
        min_c = c;
        imin = i;
      }
    }
    v[j] = min_c;
    if (++matches[imin] == 1) {
      rowsol[imin] = j;
      colsol[j] = imin;
    }
  }

  // Rows that matched more than once or never become "free".
  int num_free = 0;
  for (int i = 0; i < n; ++i) {
    if (matches[i] == 0) {
      free_rows[num_free++] = i;
    } else if (matches[i] > 1) {
      // keep only the first assignment; re-free the row
      // (standard JV: rows with multiple column minima stay assigned once)
      ;
    } else {
      // uniquely matched: reduction transfer
      int j1 = rowsol[i];
      double min_c = DBL_MAX;
      for (int j = 0; j < n; ++j) {
        if (j != j1) {
          double c = cost[i * n + j] - v[j];
          if (c < min_c) min_c = c;
        }
      }
      v[j1] -= min_c;
    }
  }

  // --- Augmenting row reduction (two passes). ---
  for (int loop = 0; loop < 2; ++loop) {
    int k = 0;
    int prev_num_free = num_free;
    num_free = 0;
    while (k < prev_num_free) {
      int i = free_rows[k++];
      // find first and second minimum reduced cost over columns
      double umin = DBL_MAX, usubmin = DBL_MAX;
      int j1 = -1, j2 = -1;
      for (int j = 0; j < n; ++j) {
        double h = cost[i * n + j] - v[j];
        if (h < usubmin) {
          if (h >= umin) {
            usubmin = h;
            j2 = j;
          } else {
            usubmin = umin;
            j2 = j1;
            umin = h;
            j1 = j;
          }
        }
      }
      int i0 = colsol[j1];
      if (umin < usubmin) {
        v[j1] -= usubmin - umin;
      } else if (i0 >= 0) {
        j1 = j2;
        i0 = colsol[j1];
      }
      rowsol[i] = j1;
      colsol[j1] = i;
      if (i0 >= 0) {
        if (umin < usubmin) {
          // push i0 to front of remaining free rows (process again now)
          free_rows[--k] = i0;
        } else {
          free_rows[num_free++] = i0;
        }
      }
    }
  }

  // --- Augmentation: shortest augmenting path for each free row. ---
  for (int f = 0; f < num_free; ++f) {
    int freerow = free_rows[f];
    for (int j = 0; j < n; ++j) {
      d[j] = cost[freerow * n + j] - v[j];
      pred[j] = freerow;
      collist[j] = j;
    }
    int low = 0, up = 0;
    int endofpath = -1;
    double min_d = 0.0;
    bool unassigned_found = false;
    while (!unassigned_found) {
      if (up == low) {
        // the current-min element itself joins the tie set: up must
        // advance past it before scanning (classic JV `d[collist[up++]]`)
        min_d = d[collist[up++]];
        for (int k = up; k < n; ++k) {
          int j = collist[k];
          double h = d[j];
          if (h <= min_d) {
            if (h < min_d) {
              up = low;
              min_d = h;
            }
            collist[k] = collist[up];
            collist[up++] = j;
          }
        }
        for (int k = low; k < up; ++k) {
          int j = collist[k];
          if (colsol[j] < 0) {
            endofpath = j;
            unassigned_found = true;
            break;
          }
        }
      }
      if (!unassigned_found) {
        int j1 = collist[low++];
        int i = colsol[j1];
        double h = cost[i * n + j1] - v[j1] - min_d;
        for (int k = up; k < n; ++k) {
          int j = collist[k];
          double v2 = cost[i * n + j] - v[j] - h;
          if (v2 < d[j]) {
            pred[j] = i;
            if (v2 == min_d) {
              if (colsol[j] < 0) {
                endofpath = j;
                unassigned_found = true;
                break;
              }
              collist[k] = collist[up];
              collist[up++] = j;
            }
            d[j] = v2;
          }
        }
      }
    }
    // update column prices for scanned columns
    for (int k = 0; k < low; ++k) {
      int j1 = collist[k];
      v[j1] += d[j1] - min_d;
    }
    // augment along the alternating path
    int i, j = endofpath;
    do {
      i = pred[j];
      colsol[j] = i;
      int tmp = rowsol[i];
      rowsol[i] = j;
      j = tmp;
    } while (i != freerow);
  }

  return 0;
}

}  // extern "C"
