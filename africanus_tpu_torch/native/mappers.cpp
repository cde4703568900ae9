// Native cores for the host-side averaging mappers.
//
// A copy of africanus_tpu/native/mappers.cpp's two mapper cores (the
// port imports nothing of the JAX package). The reference compiles these
// loops with numba (averaging/time_and_channel_mapping.py row_mapper,
// averaging/bda_mapping.py Binner); numba is not a dependency, and the
// loops are serial per baseline with data-dependent outputs, so they run
// on the host in C++, in threads over baselines.
//
// Built by africanus_tpu_torch.native (g++ -O3 -shared -fPIC) into the
// repository's build/ directory at first use, bound via ctypes.

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

constexpr double kLightspeed = 2.99792458e8;

// Run fn(bl_begin, bl_end) over contiguous baseline ranges on worker
// threads. Baselines are fully independent in every mapper below (each
// writes only its own (bl, :) rows), so this is a plain static split;
// small problems stay single-threaded to dodge spawn overhead.
template <typename Fn>
void parallel_over_baselines(int64_t nbl, int64_t ntime, Fn&& fn) {
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  const int64_t min_work = 1 << 15;  // ~32k cells per thread minimum
  int64_t nthreads = std::min<int64_t>(hw, std::max<int64_t>(
      1, (nbl * ntime) / min_work));
  nthreads = std::min<int64_t>(nthreads, nbl);
  if (nthreads <= 1) {
    fn(0, nbl);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(nthreads);
  const int64_t chunk = (nbl + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    const int64_t b0 = t * chunk;
    const int64_t b1 = std::min(nbl, b0 + chunk);
    if (b0 >= b1) break;
    workers.emplace_back([&fn, b0, b1] { fn(b0, b1); });
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// Time+channel row binning (reference time_and_channel_mapping.py:248-312).
//
// row_lookup: (nbl, ntime) int32, -1 for missing.
// Outputs (preallocated): bin_lookup (nbl, ntime) int32 (-1 init),
// time_lookup/interval_lookup (nbl, ntime) f64 (zero init),
// bin_flagged (nbl, ntime) uint8 (zero init).
// time_lookup of unoccupied bins is set to `sentinel`.
// Returns the total number of output rows.
int64_t tc_row_mapper_core(
    int64_t nbl, int64_t ntime,
    const int32_t* row_lookup,
    const double* time,
    const double* interval,
    const uint8_t* flag_row,  // may be null
    double time_bin_secs,
    double sentinel,
    int32_t* bin_lookup,
    double* time_lookup,
    double* interval_lookup,
    uint8_t* bin_flagged) {
  std::vector<int64_t> rows_per_bl(static_cast<size_t>(nbl), 0);

  parallel_over_baselines(nbl, ntime, [&](int64_t bl0, int64_t bl1) {
    for (int64_t bl = bl0; bl < bl1; ++bl) {
      int64_t tbin = 0;
      int64_t bin_count = 0;
      int64_t bin_flag_count = 0;
      double bin_low = 0.0;
      const int64_t base = bl * ntime;

      for (int64_t t = 0; t < ntime; ++t) {
        const int32_t r = row_lookup[base + t];
        if (r == -1) continue;

        const double half_int = interval[r] * 0.5;
        if (bin_count == 0) {
          bin_low = time[r] - half_int;
        } else if (time[r] + half_int - bin_low > time_bin_secs) {
          time_lookup[base + tbin] /= static_cast<double>(bin_count);
          bin_flagged[base + tbin] = (bin_count == bin_flag_count) ? 1 : 0;
          ++tbin;
          bin_count = 0;
          bin_low = time[r] - half_int;
          bin_flag_count = 0;
        }

        bin_lookup[base + t] = static_cast<int32_t>(tbin);
        time_lookup[base + tbin] += time[r];
        interval_lookup[base + tbin] += interval[r];
        ++bin_count;
        if (flag_row != nullptr && flag_row[r] != 0) ++bin_flag_count;
      }

      if (bin_count > 0) {
        time_lookup[base + tbin] /= static_cast<double>(bin_count);
        bin_flagged[base + tbin] = (bin_count == bin_flag_count) ? 1 : 0;
        ++tbin;
      }

      rows_per_bl[bl] = tbin;
      for (int64_t b = tbin; b < ntime; ++b) {
        time_lookup[base + b] = sentinel;
        bin_flagged[base + b] = 0;
      }
    }
  });

  int64_t out_rows = 0;
  for (int64_t bl = 0; bl < nbl; ++bl) out_rows += rows_per_bl[bl];
  return out_rows;
}

// BDA per-baseline greedy binning (reference bda_mapping.py Binner:62).
//
// uvw: (nrow, 3) f64; chan_width: (nchan,) f64;
// nchan_factors: sorted factors of nchan (nfactors int64).
// Outputs (preallocated, shapes (nbl, ntime)):
//   bin_lookup int32 (-1 init), time_lookup f64 (sentinel init),
//   interval_lookup f64 (sentinel init), bin_flagged uint8 (0),
//   bin_nchan int64 (0) — the finalised per-bin output channel count
//   (pre min_nchan clamp), from which the channel map is derived.
// out_counts: int64[2] -> {out_rows, out_row_chans}.
void bda_binner_core(
    int64_t nbl, int64_t ntime, int64_t nchan,
    const int32_t* row_lookup,
    const uint8_t* auto_corr,  // (nbl,) 1 if ant1 == ant2
    const double* time,
    const double* interval,
    const double* uvw,
    const uint8_t* flag_row,  // may be null
    const double* chan_width,
    const int64_t* nchan_factors, int64_t nfactors,
    double max_lm, double n_max, double dphi,
    double time_bin_secs, double max_chan_freq,
    double bandwidth, int64_t min_nchan,
    double sentinel,
    int32_t* bin_lookup,
    double* time_lookup,
    double* interval_lookup,
    uint8_t* bin_flagged,
    int64_t* bin_nchan_out,
    double* bin_chan_width,
    int64_t* out_counts) {
  const double sinc_dphi = (dphi == 0.0) ? 1.0 : std::sin(M_PI * dphi) / (M_PI * dphi);
  std::vector<int64_t> rows_per_bl(static_cast<size_t>(nbl), 0);
  std::vector<int64_t> row_chans_per_bl(static_cast<size_t>(nbl), 0);

  parallel_over_baselines(nbl, ntime, [&](int64_t bl0, int64_t bl1) {
  for (int64_t bl = bl0; bl < bl1; ++bl) {
    const int64_t base = bl * ntime;
    const bool is_auto = auto_corr[bl] != 0;

    int64_t out_rows = 0;
    int64_t out_row_chans = 0;
    int64_t tbin = 0;
    int64_t bin_count = 0;
    int64_t bin_flag_count = 0;
    int64_t rs = 0, re = 0;

    auto finalise = [&]() {
      // finalise_bin (reference bda_mapping.py:168-232)
      double btime, bint;
      int64_t fnchan;
      if (bin_count == 1) {
        btime = time[rs];
        bint = interval[rs];
        fnchan = nchan;
      } else {
        if (is_auto) {
          fnchan = 1;
        } else {
          const double cu = (uvw[rs * 3 + 0] + uvw[re * 3 + 0]) * 0.5;
          const double cv = (uvw[rs * 3 + 1] + uvw[re * 3 + 1]) * 0.5;
          const double cw = (uvw[rs * 3 + 2] + uvw[re * 3 + 2]) * 0.5;
          const double cuv = std::sqrt(cu * cu + cv * cv);
          const double max_abs_dist =
              std::sqrt(std::fabs(cuv) * std::fabs(max_lm) +
                        std::fabs(cw) * std::fabs(n_max));
          const double delta_nu =
              (kLightspeed / (2.0 * M_PI)) * (dphi / max_abs_dist);
          double frac = 1e300;
          for (int64_t c = 0; c < nchan; ++c) {
            frac = std::min(frac, delta_nu / chan_width[c]);
          }
          frac = std::max(frac, 1.0);
          const double want = std::ceil(static_cast<double>(nchan) / frac);
          // next factor >= want
          int64_t idx = nfactors - 1;
          for (int64_t i = 0; i < nfactors; ++i) {
            if (static_cast<double>(nchan_factors[i]) >= want) {
              idx = i;
              break;
            }
          }
          fnchan = nchan_factors[idx];
        }
        const double t0 = time[rs] - interval[rs] * 0.5;
        const double t1 = time[re] + interval[re] * 0.5;
        btime = (t0 + t1) * 0.5;
        bint = t1 - t0;
      }

      time_lookup[base + tbin] = btime;
      interval_lookup[base + tbin] = bint;
      bin_flagged[base + tbin] = (bin_count == bin_flag_count) ? 1 : 0;
      bin_nchan_out[base + tbin] = fnchan;
      bin_chan_width[base + tbin] = bandwidth / static_cast<double>(fnchan);
      const int64_t use_nchan = std::max(fnchan, min_nchan);
      ++out_rows;
      out_row_chans += use_nchan;
      ++tbin;
    };

    for (int64_t t = 0; t < ntime; ++t) {
      const int32_t r = row_lookup[base + t];
      if (r == -1) continue;

      if (bin_count == 0) {
        rs = re = r;
        bin_count = 1;
        bin_flag_count = (flag_row != nullptr && flag_row[r] != 0) ? 1 : 0;
      } else {
        // add_row (reference bda_mapping.py:95-160)
        bool accepted;
        if (is_auto) {
          accepted = true;
        } else {
          const double dt = (time[r] + interval[r] * 0.5) -
                            (time[rs] - interval[rs] * 0.5);
          const double du = uvw[r * 3 + 0] - uvw[rs * 3 + 0];
          const double dv = uvw[r * 3 + 1] - uvw[rs * 3 + 1];
          const double dw = uvw[r * 3 + 2] - uvw[rs * 3 + 2];
          const double half_dpsi =
              std::sqrt(du * du + dv * dv + dw * dw) * max_chan_freq *
                  std::sin(std::fabs(max_lm)) * M_PI / kLightspeed +
              1.0e-8;
          const double bldecorr = std::sin(half_dpsi) / half_dpsi;
          accepted = !(bldecorr < sinc_dphi || dt > time_bin_secs);
        }

        if (accepted) {
          re = r;
          ++bin_count;
          if (flag_row != nullptr && flag_row[r] != 0) ++bin_flag_count;
        } else {
          finalise();
          rs = re = r;
          bin_count = 1;
          bin_flag_count = (flag_row != nullptr && flag_row[r] != 0) ? 1 : 0;
        }
      }
      bin_lookup[base + t] = static_cast<int32_t>(tbin);
    }

    if (bin_count > 0) finalise();

    for (int64_t b = tbin; b < ntime; ++b) {
      time_lookup[base + b] = sentinel;
      bin_flagged[base + b] = 0;
    }
    rows_per_bl[bl] = out_rows;
    row_chans_per_bl[bl] = out_row_chans;
  }
  });

  out_counts[0] = 0;
  out_counts[1] = 0;
  for (int64_t bl = 0; bl < nbl; ++bl) {
    out_counts[0] += rows_per_bl[bl];
    out_counts[1] += row_chans_per_bl[bl];
  }
}

}  // extern "C"
