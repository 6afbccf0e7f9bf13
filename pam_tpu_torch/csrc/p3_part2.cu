// P3 part 2 in one launch from part 1's state: the DSD precursors, the
// table index walks and lookups (stage A), then the process rates,
// conservation limiters, prognostic updates, final clipping and in-cloud
// ratios of every point (the core).
//
// Replaces the Pallas TPU kernel of pam_tpu/physics/p3/main.py:780
// (p3_main_part2, its use_pallas branch; body `kernel` :832, call :850),
// which runs _part2_core (:320-767) over (nz, 256) column blocks on table
// values that _part2_tables (:270-317) contracts from dense hat weights
// beforehand. On this card that split is the wrong way round: a lookup
// is 8 + 16 + 4 table reads a point, the tables fit L2, and the dense
// form writes ~1,800 intermediate values a point to device memory. So
// stage A runs here, per thread, with the lookups as gathers
// (csrc/p3_tables.cuh), and hands its 24 values to the core in registers.
//
// Plain version: pam_tpu_torch/physics/p3/main.py::_part2_tables followed
// by ::_part2_core (ops/p3_part2.py::p3_part2_reference). The kernel
// computes the same expressions in the same order, with every literal
// rounded to T as PyTorch rounds a Python scalar (1e-300 is 0 in float,
// as there) and the same selections; built with -fmad=false (_cuda.py),
// every product and sum rounds as in the plain version's separate
// launches. Where the plain version selects between a computed value and
// a constant (torch.where(has_rain, rate, 0)), the kernel branches on
// the same condition: a warp in which no lane holds the species skips
// that group's pow/exp/log chain, and every result stays the selected
// one.
//
// What bounds it: it reads 36 arrays and writes 28, with no reuse:
// 64 x 4 B x N of memory traffic (106.5 MB at N = 416,000 in float32),
// then the issue rate of the precise pow/exp/log/log10 chain. Design:
// one thread per point in a grid-stride loop: load, stage A, core,
// store; every intermediate stays in registers. The array pointers
// travel in one struct by value, the constants in a second one, in T,
// filled on the host from physics/p3/constants.py
// (ops/p3_part2.py::_constants). The precise pow, exp, log, log10 and
// tanh are one shared body each (csrc/p3_tables.cuh).
//
// Plain C entry points (ctypes): pam_p3_part2_f32 / pam_p3_part2_f64
// return the cudaError_t of the launch; pam_p3_part2_layout returns
// NIN * 1000000 + NOUT * 10000 + NCONST * 100 + NTAB and
// pam_p3_part2_table_size(k) the element count of table k for the
// wrapper's layout check.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include "p3_tables.cuh"

namespace {

using p3::clip;
using p3::cmax;
using p3::cmin;
using p3::exp_;
using p3::log10_;
using p3::log_;
using p3::pow_;
using p3::tanh_;
using p3::tmax;
using p3::tmin;

constexpr int NIN = 36;
constexpr int NOUT = 28;
constexpr int NCONST = 50;
constexpr int NTAB = 4;
constexpr double kPi = 3.141592653589793;  // numpy.pi

// Threads a block, and the blocks an SM must hold (caps the registers):
// 96 registers in float, 168 in double, a few words spilled in each.
constexpr int THREADS = 128;
template <typename T>
constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 5 : 3;

// The constants in T: the first NCONST in the order of
// ops/p3_part2.py::_constants, which computes them in Python floats as
// the plain version does; launch() rounds each to T once, as PyTorch
// rounds a Python scalar that meets a tensor, and adds the two
// reciprocals that PyTorch takes in T when a tensor is divided by a
// Python scalar on the card.
template <typename T>
struct P3Consts {
  T lv, ls, lf, rv, cp, inv_cp, T_zerodegc, T_rainfrz, T_icenuc, eci, eri,
      inv_dropmass, cpw, aimm, cons3, cons5, cons6, f1r, f2r, mi0,
      nmltratio, inv_rho_rimeMax, nccnst, ep_2, max_total_ni, rho_h2o,
      qsmall, mincld, incloud_limit, precip_limit,
      // stage A
      nsmall, mu_r, cons1, rho_rimeMin, rho_rimeMax, table_1a_c, gam_mur1,
      log_gam_mur1, log_gam_mur4, log10_gam_mur1,
      // products and sums of the above, taken in Python floats
      mu_r1, mu_r2, mu_r3, lamr_max, lamr_min, pi_rho_h2o, ls_inv_cp, ls_sq,
      cp_rv, two_pi,
      // 1 / cons1 and 1 / gam_mur1 in T
      inv_cons1, inv_gam_mur1;
};
static_assert(sizeof(P3Consts<double>) == (NCONST + 2) * sizeof(double),
              "P3Consts");

template <typename T>
struct Args {
  const T* in[NIN];
  T* out[NOUT];
  // the lookup tables of physics/p3/tables.py::device_tables in T, and
  // the values that are one number a launch, as PyTorch computes them in
  // T on the card (ops/p3_part2.py::kernel_tables): exp(lgamma(mu_r +
  // {2, 4, 7})), the logarithms of the last two, log(T_zerodegc) and
  // tanh(0.0415 (T_zerodegc - 218.8))
  const T* ice;
  const T* collect;
  const T* revap;
  const T* scalars;
};
constexpr int NSCALARS = 7;

// One point's inputs: the 10 arguments, the 18 _PART2_ST_KEYS fields and
// the 8 in-cloud ratios of part 1, in the order of Args::in
template <typename T>
struct Point {
  T pres, inv_exner, cld_frac_l, cld_frac_i, cld_frac_r, inv_cl, inv_ci,
      inv_cr, qv_prev, t_prev;
  T t, rho, inv_rho, qv, th, qc, nc, qr, nr, qi, ni, qm, bm, qv_sat_l,
      qv_sat_i, sup_i, rhofaci, acn;
  T qc_in, qr_in, qi_in, qm_in, nc_in, nr_in, ni_in, bm_in;
};
static_assert(sizeof(Point<double>) == NIN * sizeof(double), "Point");

// What stage A hands to the core (main.py::_PART2_TV_NAMES without mu_r,
// cdist and cdist1, which the core does not read)
template <typename T>
struct TableValues {
  T lamr, cdistr, logn0r, nr_in_dsd, nr_in, ni_in, qm_in2, bm_in2;
  T qi_fallspd, ni_selfcol, qc2qi_col, qi2qr_melt, ni_lammax, ni_lammin,
      qi2qr_vent, nr_col, qr2qi_col, revap;
  T nc_in, mu_c, lamc, gam_mur2, log_gam_mur4, log_gam_mur7;
  // log(T_zerodegc) and tanh(0.0415 (T_zerodegc - 218.8)) of
  // qv_sat(T_zerodegc, pres)
  T log_T0, tanh_T0;
};

#define K(x) static_cast<T>(x)
#define CBRT(x) pow_((x), K(1.0 / 3.0))

// qv_sat(t, p, ice=False): Murphy-Koop liquid svp; a Python scalar over a
// tensor (c / t) is PyTorch's reciprocal(t) * c
template <typename T>
__device__ __forceinline__ T qv_sat_liq(T t, T logt, T tanht, T p,
                                        const P3Consts<T>& c) {
  T rt = K(1.0) / t;
  T tmp = K(54.842763) - rt * K(6763.22) - logt * K(4.210) +
          t * K(0.000367) +
          tanht * (K(53.878) - rt * K(1331.22) - logt * K(9.44523) +
                   t * K(0.014025));
  T e = exp_(tmp);
  return e * c.ep_2 / cmax(p - e, K(1.0e-3));
}
template <typename T>
__device__ __forceinline__ T qv_sat_liq(T t, T p, const P3Consts<T>& c) {
  return qv_sat_liq(t, log_(t), tanh_((t - K(218.8)) * K(0.0415)), p, c);
}

// _expm1 of physics/p3/main.py (Kahan's form); u = exp(x) >= 0, so
// isinf(u) is u == +inf
template <typename T>
__device__ __forceinline__ T expm1_kahan(T x) {
  T u = exp_(x);
  T um1 = u - T(1.0);
  return u == T(1.0)
             ? x
             : (um1 == T(-1.0) ? T(-1.0)
                               : (u == T(INFINITY) ? u : um1 * x / log_(u)));
}

// impose_max_total_ni(ni, inv_rho)
template <typename T>
__device__ __forceinline__ T impose_max_total_ni(T ni, T inv_rho,
                                                 const P3Consts<T>& c) {
  if (!(ni >= K(1e-20))) return ni;
  const T dum = c.max_total_ni * inv_rho / cmax(ni, K(1e-300));
  return ni * cmin(dum, K(1.0));
}

// ------------------------------------------------------------------ stage A
// main.py::_part2_tables for one point: rain_dsd, cloud_dsd, the rain
// gamma factors, impose_max_total_ni, bulk_rho_rime, the three index
// walks and the lookups. A species that is absent takes the values the
// plain version selects for it (0, or the input number) without the
// lookups: the core reads an ice value only where qi_in >= QSMALL, a
// collection value only where rain is there too, revap only with rain.
template <typename T>
__device__ __forceinline__ TableValues<T> stage_a(const Point<T>& p,
                                                  const Args<T>& a,
                                                  const P3Consts<T>& c) {
  const T QS = c.qsmall, NS = c.nsmall;
  const bool has_c = p.qc_in >= QS, has_r = p.qr_in >= QS,
             has_i = p.qi_in >= QS;
  TableValues<T> v;

  // rain_dsd(qr_in, nr_in) (:1839-1893), mu_r constant
  v.nr_in_dsd = p.nr_in;
  v.lamr = v.cdistr = v.logn0r = v.revap = K(0.0);
  if (has_r) {
    T nr = cmax(p.nr_in, NS);
    T lamr = CBRT(c.cons1 * nr * c.mu_r3 * c.mu_r2 * c.mu_r1 /
                  cmax(p.qr_in, K(1e-300)));
    const T lammax = c.lamr_max, lammin = c.lamr_min;
    lamr = clip(lamr, lammin, lammax);
    if (lamr == lammin || lamr == lammax)
      nr = exp_(log_(lamr) * K(3.0) + log_(cmax(p.qr_in, K(1e-300))) +
                c.log_gam_mur1 - c.log_gam_mur4) *
           c.inv_cons1;
    v.nr_in_dsd = nr;
    v.lamr = lamr;
    v.cdistr = nr * c.inv_gam_mur1;
    v.logn0r = log10_(cmax(nr, K(1e-300))) + log10_(lamr) * c.mu_r1 -
               c.log10_gam_mur1;
    // rain-evaporation ventilation table (:2358-2410)
    v.revap = p3::rain_lookup(
        a.revap, p3::indices_3(c.mu_r, cmax(lamr, K(1e-300))));
  }

  // cloud_dsd(qc_in, nc_in, rho) (:1774-1835), without cdist and cdist1
  v.nc_in = p.nc_in;
  v.mu_c = v.lamc = K(0.0);
  if (has_c) {
    T nc = cmax(p.nc_in, NS);
    T mu = nc * K(1.0e-6) * p.rho * K(0.0005714) + K(0.2714);
    mu = K(1.0) / (mu * mu) - K(1.0);
    mu = clip(mu, K(2.0), K(15.0));
    T lamc = CBRT(c.cons1 * nc * (mu + K(3.0)) * (mu + K(2.0)) *
                  (mu + K(1.0)) / cmax(p.qc_in, K(1e-300)));
    const T lammin = (mu + K(1.0)) * K(2.5e4);
    const T lammax = (mu + K(1.0)) * K(1.0e6);
    lamc = tmin(tmax(lamc, lammin), lammax);
    if (lamc == lammin || lamc == lammax)
      nc = lamc * lamc * lamc * K(6.0) * p.qc_in /
           (c.pi_rho_h2o * (mu + K(3.0)) * (mu + K(2.0)) *
            (mu + K(1.0)));
    v.nc_in = nc;
    v.mu_c = mu;
    v.lamc = lamc;
  }

  v.gam_mur2 = __ldg(a.scalars);
  v.log_gam_mur4 = __ldg(a.scalars + 3);
  v.log_gam_mur7 = __ldg(a.scalars + 4);
  v.log_T0 = __ldg(a.scalars + 5);
  v.tanh_T0 = __ldg(a.scalars + 6);

  const T ni_t = impose_max_total_ni(p.ni_in, p.inv_rho, c);
  v.ni_in = ni_t;
  v.nr_in = v.nr_in_dsd;
  v.qm_in2 = v.bm_in2 = K(0.0);
  v.qi_fallspd = v.ni_selfcol = v.qc2qi_col = v.qi2qr_melt = v.ni_lammax =
      v.ni_lammin = v.qi2qr_vent = v.nr_col = v.qr2qi_col = K(0.0);
  if (has_i) {
    v.ni_in = cmax(ni_t, NS);
    v.nr_in = cmax(v.nr_in_dsd, NS);
    // bulk_rho_rime(qi_in, qm_in, bm_in) (:1897-1943)
    const bool has = p.bm_in >= K(1.0e-15);
    T rhop = has ? p.qm_in / cmax(p.bm_in, K(1e-300)) : K(0.0);
    const bool out_of_range =
        (rhop < c.rho_rimeMin) || (rhop > c.rho_rimeMax);
    rhop = clip(rhop, c.rho_rimeMin, c.rho_rimeMax);
    T bi = (has && out_of_range) ? p.qm_in / rhop : p.bm_in;
    T qi_r = has ? p.qm_in : K(0.0);
    bi = has ? bi : K(0.0);
    rhop = has ? rhop : K(0.0);
    const bool over = (qi_r > p.qi_in) && (rhop > K(0.0));
    qi_r = over ? p.qi_in : qi_r;
    bi = over ? qi_r / cmax(rhop, K(1e-300)) : bi;
    const bool small = qi_r < QS;
    v.qm_in2 = small ? K(0.0) : qi_r;
    v.bm_in2 = small ? K(0.0) : bi;

    // the 7 ice-table entries the core reads (1-based 2, 3, 4, 5, 7, 8,
    // 10) at one position
    const p3::IcePos<T> pos =
        p3::indices_1a(cmax(p.qi_in, K(1e-300)), cmax(v.ni_in, NS), v.qm_in2,
                       rhop, c.table_1a_c);
    T ice[7];
    p3::ice_lookup<T, 1, 2, 3, 4, 6, 7, 9>(a.ice, pos, ice);
    v.qi_fallspd = ice[0];
    v.ni_selfcol = ice[1];
    v.qc2qi_col = ice[2];
    v.qi2qr_melt = ice[3];
    v.ni_lammax = ice[4];
    v.ni_lammin = ice[5];
    v.qi2qr_vent = ice[6];
    if (has_r) {
      T coll[p3::COLL_ENTRIES];
      p3::collect_lookup(
          a.collect, pos,
          p3::indices_1b(p.qr_in, v.nr_in, c.pi_rho_h2o), coll);
      v.nr_col = coll[0];
      v.qr2qi_col = coll[1];
    }
  }
  return v;
}

// --------------------------------------------------------------------- core
// main.py::_part2_core for one point; o holds the 12 _PART2_OUT_KEYS, the
// 8 in-cloud ratios, the 7 _PART2_DIAG_KEYS and lamr. The ice, cloud and
// rain process groups run only where their species is there; a rate that
// is skipped keeps the 0 that the plain version selects for it.
template <typename T>
__device__ __forceinline__ void core(const Point<T>& p,
                                     const TableValues<T>& tv,
                                     const P3Consts<T>& c, T dt, T inv_dt,
                                     int ccn_const, T (&o)[NOUT]) {
  const T QS = c.qsmall;
  const T lv = c.lv, ls = c.ls, lf = c.lf;
  const T inv_cp = c.inv_cp;
  const T T0 = c.T_zerodegc;
  const T pres = p.pres, inv_exner = p.inv_exner, cld_frac_l = p.cld_frac_l,
          cld_frac_i = p.cld_frac_i, cld_frac_r = p.cld_frac_r;
  const T t = p.t, rho = p.rho, inv_rho = p.inv_rho;
  T qv = p.qv, th = p.th, qc = p.qc, nc = p.nc, qr = p.qr, nr = p.nr,
    qi = p.qi, ni = p.ni, qm = p.qm, bm = p.bm;
  const T qv_sat_l = p.qv_sat_l, qv_sat_i = p.qv_sat_i, rhofaci = p.rhofaci;
  const T qc_in = p.qc_in, qr_in = p.qr_in, qi_in = p.qi_in;
  const T nc_in = tv.nc_in, nr_in = tv.nr_in, mu_c = tv.mu_c, lamc = tv.lamc;
  const bool has_c = qc_in >= QS, has_r = qr_in >= QS, has_i = qi_in >= QS;

  // time/space physical variables (:3538-3585); all but the freezing
  // flag enter only rates of ice and rain
  T mu = K(0.0), dv = K(0.0), cbrt_sc = K(0.0), kap = K(0.0),
    dqsdt = K(0.0), ab = K(0.0), abi = K(0.0);
  if (has_i || has_r) {
    mu = K(1.496e-6) * pow_(t, K(1.5)) / (t + K(120.0));
    dv = K(8.794e-5) * pow_(t, K(1.81)) / pres;
    cbrt_sc = CBRT(mu / (rho * dv));
    kap = K(1.414e3) * mu;
    const T dum = K(1.0) / (c.rv * t * t);
    dqsdt = lv * qv_sat_l * dum;
    const T dqsidt = ls * qv_sat_i * dum;
    ab = K(1.0) + dqsdt * lv * inv_cp;
    abi = K(1.0) + dqsidt * ls * inv_cp;
  }
  const bool frz = t <= T0;

  // DSDs (:626-632), from stage A
  nc = has_c ? nc_in * cld_frac_l : nc;
  nr = has_r ? tv.nr_in_dsd * cld_frac_r : nr;

  // ------------------------------------------------------------ ice group
  T qccol = K(0.0), nc_collect = K(0.0), qc2qr_ice_shed = K(0.0),
    ncshdc = K(0.0), qrcol = K(0.0), nr_collect = K(0.0),
    ni_selfcollect = K(0.0), qi2qr_melt = K(0.0), ni2nr_melt = K(0.0),
    nr_ice_shed = K(0.0), epsi = K(0.0), rho_qm_cloud = K(400.0),
    qi2qv_sublim = K(0.0), ni_sublim = K(0.0), qidep = K(0.0),
    qiberg = K(0.0);
  bool log_wetgrowth = false;
  if (has_i) {
    const T qm_in = tv.qm_in2, bm_in = tv.bm_in2;
    qm = qm_in * cld_frac_i;
    bm = bm_in * cld_frac_i;
    // lambda limiters on ni (:677-678)
    T ni_in = tv.ni_in;
    ni_in = tmin(ni_in, tv.ni_lammax * ni_in);
    ni_in = tmax(ni_in, tv.ni_lammin * ni_in);

    // ice_cldliq_collection (:2054-2100)
    if (has_c) {
      const T col_base = rhofaci * tv.qc2qi_col * c.eci * rho * ni_in;
      qccol = frz ? col_base * qc_in : K(0.0);
      nc_collect = col_base * nc_in;
      qc2qr_ice_shed = !frz ? col_base * qc_in : K(0.0);
      ncshdc = !frz ? qc2qr_ice_shed * c.inv_dropmass : K(0.0);
    }

    // ice_rain_collection (:2103-2157)
    if (has_r) {
      const T base_r = rho * rhofaci * c.eri * ni_in;
      qrcol = frz ? pow_(K(10.0), tv.qr2qi_col + tv.logn0r) * base_r : K(0.0);
      nr_collect = pow_(K(10.0), tv.nr_col + tv.logn0r) * base_r;
    }

    // ice_self_collection (:2159-2207)
    const T eii =
        t < K(253.15)
            ? K(0.001)
            : (t < K(273.15)
                   ? (t - K(253.15)) * K(0.3 - 0.001) / K(20.0) + K(0.001)
                   : K(0.3));
    const T fr = qm_in / cmax(qi_in, K(1e-300));
    const T eii_fact =
        qm_in > K(0.0)
            ? (fr < K(0.6) ? K(1.0)
                           : (fr < K(0.9) ? K(1.0) - (fr - K(0.6)) / K(0.3)
                                          : K(0.0)))
            : K(1.0);
    ni_selfcollect =
        tv.ni_selfcol * rho * eii * eii_fact * rhofaci * ni_in * ni_in;

    // ice_melting (:2211-2256) and ice_cldliq_wet_growth (:2259-2319)
    const T vent = tv.qi2qr_melt +
                   tv.qi2qr_vent * cbrt_sc * sqrt(rhofaci * rho / mu);
    const bool melt = t > T0;
    const bool wet_act = ((qc_in + qr_in) >= K(1e-6)) && (t < T0);
    if (melt || wet_act) {
      const T qsat0 = qv_sat_liq(T0, tv.log_T0, tv.tanh_T0, pres, c);
      if (melt) {
        qi2qr_melt =
            cmax(vent * ((t - T0) * kap - rho * lv * dv * (qsat0 - qv)) *
                     K(2.0) * K(kPi) / lf * ni_in,
                 K(0.0));
        ni2nr_melt = qi2qr_melt * (ni_in / cmax(qi_in, K(1e-300)));
      }
      if (wet_act) {
        const T qwgrth =
            cmax(vent * K(2.0) * K(kPi) *
                     (rho * lv * dv * (qsat0 - qv) - (t - T0) * kap) /
                     ((t - T0) * c.cpw + lf) * ni_in,
                 K(0.0));
        const T dum_w = cmax((qccol + qrcol) - qwgrth, K(0.0));
        const bool shed = dum_w >= K(1e-10);
        nr_ice_shed = shed ? dum_w * K(1.923e6) : K(0.0);
        const bool big = shed && ((qccol + qrcol) >= K(1e-10));
        const T dum1_w = K(1.0) / cmax(qccol + qrcol, K(1e-300));
        qc2qr_ice_shed =
            big ? qc2qr_ice_shed + dum_w * qccol * dum1_w : qc2qr_ice_shed;
        const T qccol_w = cmax(qccol - dum_w * qccol * dum1_w, K(0.0));
        const T qrcol_w = cmax(qrcol - dum_w * qrcol * dum1_w, K(0.0));
        qccol = big ? qccol_w : qccol;
        qrcol = big ? qrcol_w : qrcol;
        log_wetgrowth = shed;
      }
    }

    // calc_ice_relaxation_timescale (:2322-2355)
    epsi = t < T0 ? vent * K(2.0) * K(kPi) * rho * dv * ni_in : K(0.0);

    // calc_rime_density (:2413-2490)
    const bool rimed = (qccol >= QS) && (t < T0);
    if (rimed && has_c) {
      const T vtrmi1 = tv.qi_fallspd * rhofaci;
      const T iTc = K(1.0) / cmin(t - T0, K(-0.001));
      const T lamc_s = cmax(lamc, K(1e-300));
      const T vt_qc =
          p.acn * (mu_c + K(5.0)) * (mu_c + K(4.0)) / (lamc_s * lamc_s);
      const T d_c = (mu_c + K(4.0)) / lamc_s;
      const T v_imp = fabs(vtrmi1 - vt_qc);
      const T Ri = clip(d_c * K(-0.5e6) * v_imp * iTc, K(1.0), K(12.0));
      rho_qm_cloud =
          Ri <= K(8.0) ? (Ri * K(0.114) + K(0.051) - Ri * K(0.0055) * Ri) *
                             K(1000.0)
                       : (Ri - K(8.0)) * K(72.25) + K(611.0);
    }

    // ice_deposition_sublimation (:3268-3333)
    if (qi_in > QS) {
      const T qi_tend_ds = cmin(epsi / abi, inv_dt) * (qv - qv_sat_i);
      if (qi_tend_ds < K(0.0)) {
        qi2qv_sublim = -qi_tend_ds;
        ni_sublim = qi2qv_sublim * (ni_in / cmax(qi_in, K(1e-300)));
      }
      qidep = (frz && (qi_tend_ds >= K(0.0))) ? qi_tend_ds : K(0.0);
      qiberg = frz ? cmax(epsi / abi * (qv_sat_l - qv_sat_i), K(0.0)) : K(0.0);
    }
  }
  const T epsi_tot = epsi;

  // immersion freezing's temperature factor, for cloud and rain
  const bool imm = t <= c.T_rainfrz;
  const T dum_if =
      (imm && (has_c || has_r)) ? exp_((T0 - t) * c.aimm) : K(0.0);

  // ---------------------------------------------------------- cloud group
  T qc2qi_hetero = K(0.0), nc2ni_immers = K(0.0), qc2qr_auto = K(0.0),
    ncautr = K(0.0), nc2nr_auto = K(0.0), qc2qr_accret = K(0.0),
    nc_accret = K(0.0);
  if (has_c) {
    // cldliq_immersion_freezing (:2504-2538)
    if (imm) {
      const T rl = K(1.0) / cmax(lamc, K(1e-300));
      const T dum2_if = rl * rl * rl;
      const T poly6 = (mu_c + K(1.0)) * (mu_c + K(2.0)) * (mu_c + K(3.0)) *
                      (mu_c + K(4.0)) * (mu_c + K(5.0)) * (mu_c + K(6.0));
      const T poly3 = (mu_c + K(1.0)) * (mu_c + K(2.0)) * (mu_c + K(3.0));
      qc2qi_hetero =
          nc_in * c.cons6 * poly6 * dum_if * (dum2_if * dum2_if);
      nc2ni_immers = nc_in * c.cons5 * poly3 * dum_if * dum2_if;
    }
    // cloud_water_autoconversion (KK2000, :2750-2784)
    if (qc_in >= K(1e-8)) {
      qc2qr_auto = pow_(qc_in, K(2.47)) * K(1350.0) *
                   pow_(nc_in * K(1e-6) * rho, K(-1.79));
      ncautr = qc2qr_auto * c.cons3;
      nc2nr_auto = qc2qr_auto * nc_in / cmax(qc_in, K(1e-300));
    }
    // cloud_rain_accretion (KK2000, :2689-2695)
    if (has_r) {
      qc2qr_accret = pow_(qc_in * qr_in, K(1.15)) * K(67.0);
      nc_accret = qc2qr_accret * nc_in / cmax(qc_in, K(1e-300));
    }
  }
  // droplet_self_collection (iparam=3 -> 0, :2646-2648)
  T nc_selfcollect = K(0.0);

  // ----------------------------------------------------------- rain group
  T qr2qi_immers = K(0.0), nr2ni_immers = K(0.0), qr2qv_evap = K(0.0),
    nr_evap = K(0.0), nr_selfcollect = K(0.0);
  if (has_r) {
    const T safe_l = cmax(tv.lamr, K(1e-300));
    // rain_immersion_freezing (:2540-2573)
    if (imm) {
      const T log_cd = log_(cmax(tv.cdistr, K(1e-300)));
      const T log_l = log_(safe_l);
      qr2qi_immers = exp_(log_cd + tv.log_gam_mur7 - log_l * K(6.0)) *
                     c.cons6 * dum_if;
      nr2ni_immers = exp_(log_cd + tv.log_gam_mur4 - log_l * K(3.0)) *
                     c.cons5 * dum_if;
    }

    // rain evaporation (:2358-2410, 3383-3536)
    const T ssat_r = qv - qv_sat_l;
    const T cld_frac = (qc_in + qi_in < K(1e-6)) ? K(0.0) : cld_frac_l;
    if ((cld_frac_r > cld_frac) && (ssat_r < K(0.0))) {
      const T epsr = tv.cdistr * c.two_pi * rho * dv *
                     (tv.gam_mur2 * c.f1r / safe_l +
                      sqrt(rho / mu) * c.f2r * cbrt_sc * tv.revap);
      const bool cold = t < K(273.15);
      const T ls_cp_dqsdt = dqsdt * c.ls_inv_cp + K(1.0);
      T eps_eff = cold ? epsr + epsi_tot * ls_cp_dqsdt / abi : epsr;
      eps_eff = cmax(eps_eff, K(1e-20));
      const T tau_eff = K(1.0) / eps_eff;
      T A_c = (qv - p.qv_prev) * inv_dt - dqsdt * (t - p.t_prev) * inv_dt;
      A_c = cold ? A_c - (qv_sat_l - qv_sat_i) * ls_cp_dqsdt / abi * epsi_tot
                 : A_c;
      const bool tiny_r = (qr_in < K(1e-12)) && (qv / qv_sat_l < K(0.999));
      const T dt_tau = (K(1.0) / tau_eff) * dt;
      const T tsw = -expm1_kahan(-dt_tau) / dt_tau;
      const T tau_r = K(1.0) / cmax(epsr, K(1e-300));
      const T equil = -A_c / ab * tau_eff / tau_r;
      const T instant = -ssat_r / (ab * tau_r);
      T evap =
          tiny_r ? qr_in * inv_dt : instant * tsw + equil * (K(1.0) - tsw);
      evap = tmin(evap, -ssat_r * inv_dt / ab);
      evap = cmax(evap, K(0.0));
      evap = tmin(evap, qr_in * inv_dt);
      qr2qv_evap =
          evap * (cld_frac_r - cld_frac) / cmax(cld_frac_r, c.mincld);
      nr_evap = qr2qv_evap * (nr_in / cmax(qr_in, K(1e-300)));
    }

    // rain_self_collection (:2705-2747)
    const T dum2_rsc =
        CBRT(qr_in / (cmax(nr_in, K(1e-300)) * c.pi_rho_h2o));
    const T dum_rsc = dum2_rsc < K(280e-6)
                          ? K(1.0)
                          : K(2.0) - exp_((dum2_rsc - K(280e-6)) * K(2300.0));
    nr_selfcollect = dum_rsc * K(5.78) * nr_in * qr_in * rho;
  }

  // ice_nucleation (:2576-2618), Cooper 1986
  T ni_nucleat = K(0.0), qinuc = K(0.0);
  if ((t < c.T_icenuc) && (p.sup_i >= K(0.05))) {
    T dum_n = exp_((T0 - t) * K(0.304)) * K(0.005) * K(1000.0) * inv_rho;
    dum_n = tmin(dum_n, inv_rho * K(100.0e3));
    const T N_nuc = cmax((dum_n - ni) * inv_dt, K(0.0));
    if (N_nuc >= K(1e-20)) {
      ni_nucleat = N_nuc;
      qinuc = cmax((dum_n - ni) * c.mi0 * inv_dt, K(0.0));
    }
  }

  // back_to_cell_average (:2786-2854)
  const T ir = tmin(cld_frac_i, cld_frac_r);
  const T il = tmin(cld_frac_i, cld_frac_l);
  const T lr = tmin(cld_frac_l, cld_frac_r);
  qc2qr_accret = qc2qr_accret * lr;
  qr2qv_evap = qr2qv_evap * cld_frac_r;
  qc2qr_auto = qc2qr_auto * cld_frac_l;
  nc_accret = nc_accret * lr;
  nc_selfcollect = nc_selfcollect * cld_frac_l;
  nc2nr_auto = nc2nr_auto * cld_frac_l;
  nr_selfcollect = nr_selfcollect * cld_frac_r;
  nr_evap = nr_evap * cld_frac_r;
  ncautr = ncautr * lr;
  qi2qv_sublim = qi2qv_sublim * cld_frac_i;
  nr_ice_shed = nr_ice_shed * il;
  qc2qi_hetero = qc2qi_hetero * il;
  qrcol = qrcol * ir;
  qc2qr_ice_shed = qc2qr_ice_shed * il;
  qi2qr_melt = qi2qr_melt * cld_frac_i;
  qccol = qccol * il;
  qr2qi_immers = qr2qi_immers * cld_frac_r;
  ni2nr_melt = ni2nr_melt * cld_frac_i;
  nc_collect = nc_collect * il;
  ncshdc = ncshdc * il;
  nc2ni_immers = nc2ni_immers * cld_frac_l;
  nr_collect = nr_collect * ir;
  ni_selfcollect = ni_selfcollect * cld_frac_i;
  qidep = qidep * cld_frac_i;
  nr2ni_immers = nr2ni_immers * cld_frac_r;
  ni_sublim = ni_sublim * cld_frac_i;
  qiberg = qiberg * il;

  // conservation limiters (:3028-3102, 2957-3026, 2856-2955); where a
  // limiter does not bind its ratio is 1 and its products change nothing
  {
    const T sinks = (qc2qr_auto + qc2qr_accret + qccol + qc2qi_hetero +
                     qc2qr_ice_shed + qiberg) *
                    dt;
    T one_minus_ratio = K(0.0);
    if ((sinks > qc) && (sinks >= K(1e-20))) {
      const T ratio = qc / cmax(sinks, K(1e-300));
      qc2qr_auto = qc2qr_auto * ratio;
      qc2qr_accret = qc2qr_accret * ratio;
      qccol = qccol * ratio;
      qc2qi_hetero = qc2qi_hetero * ratio;
      qc2qr_ice_shed = qc2qr_ice_shed * ratio;
      qiberg = qiberg * ratio;
      one_minus_ratio = K(1.0) - ratio;
    }
    if (qc > K(1e-20)) {   // liquid present
      qidep = qidep * one_minus_ratio;
      qi2qv_sublim = qi2qv_sublim * one_minus_ratio;
    }
  }
  {
    const T sinks = (qr2qv_evap + qrcol + qr2qi_immers) * dt;
    const T sources =
        (qc2qr_auto + qc2qr_accret + qi2qr_melt + qc2qr_ice_shed) * dt + qr;
    if ((sinks > sources) && (sinks >= K(1e-20))) {
      const T ratio = sources / cmax(sinks, K(1e-300));
      qr2qv_evap = qr2qv_evap * ratio;
      qrcol = qrcol * ratio;
      qr2qi_immers = qr2qi_immers * ratio;
    }
  }
  {
    const T sinks = (qi2qv_sublim + qi2qr_melt) * dt;
    const T sources = (qidep + qinuc + qrcol + qccol + qr2qi_immers +
                       qc2qi_hetero + qiberg) *
                          dt +
                      qi;
    if ((sinks > sources) && (sinks >= K(1e-20))) {
      const T ratio = sources / cmax(sinks, K(1e-300));
      qi2qv_sublim = qi2qv_sublim * ratio;
      qi2qr_melt = qi2qr_melt * ratio;
    }
  }
  {
    const T sink_nc =
        (nc_collect + nc2ni_immers + nc_accret + nc2nr_auto) * dt;
    const T source_nc = nc_selfcollect * dt + nc;
    if (sink_nc > source_nc) {
      const T ratio = source_nc / cmax(sink_nc, K(1e-300));
      nc_collect = nc_collect * ratio;
      nc2ni_immers = nc2ni_immers * ratio;
      nc_accret = nc_accret * ratio;
      nc2nr_auto = nc2nr_auto * ratio;
    }
  }
  {
    const T sink_nr =
        (nr_collect + nr2ni_immers + nr_selfcollect + nr_evap) * dt;
    const T source_nr = (ni2nr_melt * c.nmltratio + nr_ice_shed + ncshdc +
                         nc2nr_auto) *
                            dt +
                        nr;
    if (sink_nr > source_nr) {
      const T ratio = source_nr / cmax(sink_nr, K(1e-300));
      nr_collect = nr_collect * ratio;
      nr2ni_immers = nr2ni_immers * ratio;
      nr_selfcollect = nr_selfcollect * ratio;
      nr_evap = nr_evap * ratio;
    }
  }
  {
    const T sink_ni = (ni2nr_melt + ni_sublim + ni_selfcollect) * dt;
    const T source_ni = (ni_nucleat + nr2ni_immers + nc2ni_immers) * dt + ni;
    if (sink_ni > source_ni) {
      const T ratio = source_ni / cmax(sink_ni, K(1e-300));
      ni2nr_melt = ni2nr_melt * ratio;
      ni_sublim = ni_sublim * ratio;
      ni_selfcollect = ni_selfcollect * ratio;
    }
  }

  // ice_supersat_conservation (:2856-2886)
  {
    const T qv_sink = qidep + qinuc;
    if ((qv_sink > QS) && (cld_frac_i > K(1e-20))) {
      T qv_avail = (qv + (qi2qv_sublim + qr2qv_evap) * dt - qv_sat_i) /
                   (c.ls_sq * qv_sat_i / (c.cp_rv * t * t) +
                    K(1.0)) /
                   dt;
      qv_avail = cmax(qv_avail, K(0.0));
      const T fract =
          qv_sink > qv_avail ? qv_avail / cmax(qv_sink, K(1e-300)) : K(1.0);
      qinuc = qinuc * fract;
      qidep = qidep * fract;
    }
  }

  // prevent_liq_supersaturation (:2888-2955)
  {
    const T qv_sources = qi2qv_sublim + qr2qv_evap;
    if (qv_sources >= QS) {
      const T qv_sinks = qidep + qinuc;
      const T T_end = t + ((qv_sinks - qi2qv_sublim) * ls * inv_cp -
                           qr2qv_evap * lv * inv_cp) *
                              dt;
      const T qsl = qv_sat_liq(T_end, pres, c);
      const T A = lv * qsl * dt * inv_cp / (c.rv * T_end * T_end) *
                  (ls * qi2qv_sublim + lv * qr2qv_evap);
      T frac = (qsl - qv + qv_sinks * dt + A) /
               cmax(qv_sources * dt + A, K(1e-300));
      frac = clip(frac, K(0.0), K(1.0));
      qi2qv_sublim = frac * qi2qv_sublim;
      qr2qv_evap = frac * qr2qv_evap;
    }
  }

  // update_prognostic_ice (:3105-3214)
  qc = qc + (-qc2qi_hetero - qccol - qc2qr_ice_shed - qiberg) * dt;
  if (!ccn_const) nc = nc + (-nc_collect - nc2ni_immers) * dt;
  qr = qr + (-qrcol + qi2qr_melt - qr2qi_immers + qc2qr_ice_shed) * dt;
  nr = nr + (-nr_collect - nr2ni_immers + ni2nr_melt * c.nmltratio +
             nr_ice_shed + ncshdc) *
                dt;
  {
    if (qi >= QS) {
      const T decay = (qi2qv_sublim + qi2qr_melt) / cmax(qi, K(1e-300)) * dt;
      bm = bm - decay * bm;
      qm = qm - decay * qm;
      qi = qi - (qi2qv_sublim + qi2qr_melt) * dt;
    }
  }
  const T dum_i = (qrcol + qccol + qr2qi_immers + qc2qi_hetero) * dt;
  qi = qi + (qidep + qinuc + qiberg) * dt + dum_i;
  qm = qm + dum_i;
  // (0 / rho_qm_cloud is the same 0: the division runs only on riming)
  bm = bm + (qrcol * c.inv_rho_rimeMax +
             (qccol == K(0.0) ? qccol : qccol / rho_qm_cloud) +
             (qr2qi_immers + qc2qi_hetero) * c.inv_rho_rimeMax) *
                dt;
  ni = ni + (ni_nucleat - ni2nr_melt - ni_sublim - ni_selfcollect +
             nr2ni_immers + nc2ni_immers) *
                dt;
  if (qm < K(0.0)) {
    qm = K(0.0);
    bm = K(0.0);
  }
  qm = log_wetgrowth ? qi : qm;
  bm = log_wetgrowth ? qm * c.inv_rho_rimeMax : bm;
  qv = qv + (-qidep + qi2qv_sublim - qinuc) * dt;
  th = th + inv_exner *
                ((qidep - qi2qv_sublim + qinuc) * ls * inv_cp +
                 (qrcol + qccol + qc2qi_hetero + qr2qi_immers - qi2qr_melt +
                  qiberg) *
                     lf * inv_cp) *
                dt;

  // update_prognostic_liquid (:3216-3266)
  qc = qc + (-qc2qr_accret - qc2qr_auto) * dt;
  qr = qr + (qc2qr_accret + qc2qr_auto - qr2qv_evap) * dt;
  if (!ccn_const) {
    nc = nc + (-nc_accret - nc2nr_auto + nc_selfcollect) * dt;
  } else {
    nc = c.nccnst * inv_rho;
  }
  nr = nr + (ncautr - nr_selfcollect - nr_evap) * dt;
  qv = qv + qr2qv_evap * dt;
  th = th + inv_exner * (-qr2qv_evap * lv * inv_cp) * dt;

  // diagnostics (:883-889)
  const T qv2qi_depos_tend = qidep - qi2qv_sublim + qinuc;
  const T precip_total_tend =
      qc2qr_accret + qc2qr_auto + qc2qr_ice_shed + qccol;
  const T nevapr = qi2qv_sublim + qr2qv_evap;
  const T vap_liq_exchange = -qr2qv_evap;
  const T liq_ice_exchange =
      qc2qi_hetero + qr2qi_immers - qi2qr_melt + qiberg + qccol + qrcol;

  // final clipping (:892-919)
  if (qc < QS) {
    qv = qv + qc;
    th = th - inv_exner * qc * lv * inv_cp;
    qc = K(0.0);
    nc = K(0.0);
  }
  if (qr < QS) {
    qv = qv + qr;
    th = th - inv_exner * qr * lv * inv_cp;
    qr = K(0.0);
    nr = K(0.0);
  }
  if (qi < QS) {
    qv = qv + qi;
    th = th - inv_exner * qi * ls * inv_cp;
    qi = K(0.0);
    ni = K(0.0);
    qm = K(0.0);
    bm = K(0.0);
  }
  ni = impose_max_total_ni(ni / cmax(cld_frac_i, c.mincld), inv_rho, c) *
       cld_frac_i;

  // incloud_ratios (micro_p3_utils.F90:237-295)
  const bool okc = qc >= QS, oki = qi >= QS, okr = qr >= QS;
  const bool okm = (qm >= QS) && oki;
  const T inv_cl = p.inv_cl, inv_ci = p.inv_ci, inv_cr = p.inv_cr;

  // the 12 _PART2_OUT_KEYS
  o[0] = qv;
  o[1] = th;
  o[2] = qc;
  o[3] = nc;
  o[4] = qr;
  o[5] = nr;
  o[6] = qi;
  o[7] = ni;
  o[8] = qm;
  o[9] = bm;
  o[10] = mu_c;
  o[11] = lamc;
  // the 8 in-cloud ratios: qc, qr, qi, qm, nc, nr, ni, bm
  o[12] = cmin(okc ? qc * inv_cl : K(0.0), c.incloud_limit);
  o[13] = cmin(okr ? qr * inv_cr : K(0.0), c.precip_limit);
  o[14] = cmin(oki ? qi * inv_ci : K(0.0), c.incloud_limit);
  o[15] = okm ? qm * inv_ci : K(0.0);
  o[16] = okc ? cmax(nc * inv_cl, K(0.0)) : K(0.0);
  o[17] = okr ? cmax(nr * inv_cr, K(0.0)) : K(0.0);
  o[18] = oki ? cmax(ni * inv_ci, K(0.0)) : K(0.0);
  o[19] = cmin(okm ? cmax(bm * inv_cl, K(0.0)) : K(0.0), c.incloud_limit);
  // the 7 _PART2_DIAG_KEYS
  o[20] = qv2qi_depos_tend;
  o[21] = precip_total_tend;
  o[22] = nevapr;
  o[23] = qr2qv_evap;
  o[24] = vap_liq_exchange;
  o[25] = qv2qi_depos_tend;
  o[26] = liq_ice_exchange;
  // stage A's rain slope, which part 2 returns beside its state
  o[27] = tv.lamr;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<T>)
    p3_part2_kernel(const Args<T> a, const P3Consts<T> c, long long n,
                    double dt_d, int ccn_const) {
  const T dt = K(dt_d);
  const T inv_dt = K(1.0 / dt_d);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    // load
    T v[NIN];
#pragma unroll
    for (int k = 0; k < NIN; ++k) v[k] = a.in[k][i];
    const Point<T> p = {
        v[0],  v[1],  v[2],  v[3],  v[4],  v[5],  v[6],  v[7],  v[8],
        v[9],  v[10], v[11], v[12], v[13], v[14], v[15], v[16], v[17],
        v[18], v[19], v[20], v[21], v[22], v[23], v[24], v[25], v[26],
        v[27], v[28], v[29], v[30], v[31], v[32], v[33], v[34], v[35]};
    // stage A, core
    T o[NOUT];
    const TableValues<T> tv = stage_a(p, a, c);
    core(p, tv, c, dt, inv_dt, ccn_const, o);
    // store
#pragma unroll
    for (int k = 0; k < NOUT; ++k) a.out[k][i] = o[k];
  }
}

#undef CBRT
#undef K

template <typename T>
int launch(const unsigned long long* ins, const unsigned long long* outs,
           const unsigned long long* tabs, long long n, double dt,
           int ccn_const, const double* consts, void* stream) {
  Args<T> a;
  for (int k = 0; k < NIN; ++k) a.in[k] = reinterpret_cast<const T*>(ins[k]);
  for (int k = 0; k < NOUT; ++k) a.out[k] = reinterpret_cast<T*>(outs[k]);
  a.ice = reinterpret_cast<const T*>(tabs[0]);
  a.collect = reinterpret_cast<const T*>(tabs[1]);
  a.revap = reinterpret_cast<const T*>(tabs[2]);
  a.scalars = reinterpret_cast<const T*>(tabs[3]);
  P3Consts<T> c;
  T* fields = reinterpret_cast<T*>(&c);
  for (int k = 0; k < NCONST; ++k) fields[k] = static_cast<T>(consts[k]);
  c.inv_cons1 = T(1.0) / c.cons1;
  c.inv_gam_mur1 = T(1.0) / c.gam_mur1;
  if (n <= 0) return 0;
  const int threads = THREADS;
  const long long blocks = (n + threads - 1) / threads;
  p3_part2_kernel<T><<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, c, n, dt,
                                                            ccn_const);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pam_p3_part2_f32(const unsigned long long* ins,
                     const unsigned long long* outs,
                     const unsigned long long* tabs, long long n, double dt,
                     int ccn_const, const double* consts, void* stream) {
  return launch<float>(ins, outs, tabs, n, dt, ccn_const, consts, stream);
}

int pam_p3_part2_f64(const unsigned long long* ins,
                     const unsigned long long* outs,
                     const unsigned long long* tabs, long long n, double dt,
                     int ccn_const, const double* consts, void* stream) {
  return launch<double>(ins, outs, tabs, n, dt, ccn_const, consts, stream);
}

int pam_p3_part2_layout() {
  return NIN * 1000000 + NOUT * 10000 + NCONST * 100 + NTAB;
}

// elements of table k in the order of Args: ice, collect, revap, scalars
int pam_p3_part2_table_size(int k) {
  using namespace p3;
  const int sizes[NTAB] = {
      DENSIZE * RIMSIZE * ISIZE * ICE_ENTRIES,
      DENSIZE * RIMSIZE * ISIZE * RCOLLSIZE * COLL_ENTRIES,
      RAIN_SIZE * RAIN_MU, NSCALARS};
  return (k >= 0 && k < NTAB) ? sizes[k] : -1;
}

}  // extern "C"
