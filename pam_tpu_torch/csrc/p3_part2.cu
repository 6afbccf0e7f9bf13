// P3 part 2, the pointwise core: process rates, conservation limiters,
// prognostic updates, final clipping and in-cloud ratios of every point.
//
// Replaces the Pallas TPU kernel of pam_tpu/physics/p3/main.py:780
// (p3_main_part2, its use_pallas branch; body `kernel` :832, call :850),
// which runs all of _part2_core (:320-767) over (nz, 256) column blocks.
// Plain version: pam_tpu_torch/physics/p3/main.py::_part2_core
// (re-exported as ops/p3_part2.py::p3_part2_reference); this kernel
// computes the same expressions in the same order, with every literal
// rounded to T as PyTorch rounds a Python scalar (1e-300 is 0 in float,
// as there), and the same selections; built with -fmad=false
// (_cuda.py), every product and sum rounds as in the plain version's
// separate launches.
//
// What bounds it: of the 63 input arrays it reads 57, and it writes 27,
// with no reuse, so memory traffic: 84 x 4 B x N (140 MB at N = 416,000
// in float32), then the pow/exp/log chain. Design: one thread per point
// in a grid-stride loop; each thread reads its values once, keeps every
// intermediate in registers and writes its 27 results once. The array
// pointers travel in one struct by value (no stacked copy), the
// constants in a second one, filled on the host from
// physics/p3/constants.py (ops/p3_part2.py::_constants).
//
// Plain C entry points (ctypes): pam_p3_part2_f32 / pam_p3_part2_f64
// return the cudaError_t of the launch; pam_p3_part2_layout returns
// NIN * 10000 + NOUT * 100 + NCONST for the wrapper's layout check.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int NIN = 63;
constexpr int NOUT = 27;
constexpr int NCONST = 30;
constexpr double kPi = 3.141592653589793;  // numpy.pi

// the order of ops/p3_part2.py::_constants
struct P3Consts {
  double lv, ls, lf, rv, cp, inv_cp, T_zerodegc, T_rainfrz, T_icenuc, eci,
      eri, inv_dropmass, cpw, aimm, cons3, cons5, cons6, f1r, f2r, mi0,
      nmltratio, inv_rho_rimeMax, nccnst, ep_2, max_total_ni, rho_h2o,
      qsmall, mincld, incloud_limit, precip_limit;
};
static_assert(sizeof(P3Consts) == NCONST * sizeof(double), "P3Consts");

template <typename T>
struct Args {
  const T* in[NIN];
  T* out[NOUT];
};

// torch.clamp / torch.maximum / torch.minimum semantics: NaN propagates
template <typename T>
__device__ __forceinline__ bool nan_(T x) {
  return x != x;
}
template <typename T>
__device__ __forceinline__ T cmax(T x, T lo) {  // clamp(x, min=lo)
  return nan_(x) ? x : (x < lo ? lo : x);
}
template <typename T>
__device__ __forceinline__ T cmin(T x, T hi) {  // clamp(x, max=hi)
  return nan_(x) ? x : (x > hi ? hi : x);
}
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return cmin(cmax(x, lo), hi);
}
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return nan_(a) ? a : (nan_(b) ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return nan_(a) ? a : (nan_(b) ? b : (a < b ? a : b));
}

// qv_sat(t, p, ice=False): Murphy-Koop liquid svp; a Python scalar over a
// tensor (c / t) is PyTorch's reciprocal(t) * c
template <typename T>
__device__ __forceinline__ T qv_sat_liq(T t, T p, const P3Consts& c) {
#define K(x) static_cast<T>(x)
  T rt = K(1.0) / t;
  T logt = log(t);
  T tmp = K(54.842763) - rt * K(6763.22) - logt * K(4.210) +
          t * K(0.000367) +
          tanh((t - K(218.8)) * K(0.0415)) *
              (K(53.878) - rt * K(1331.22) - logt * K(9.44523) +
               t * K(0.014025));
  T e = exp(tmp);
  return e * K(c.ep_2) / cmax(p - e, K(1.0e-3));
#undef K
}

// _expm1 of physics/p3/main.py (Kahan's form); u = exp(x) >= 0, so
// isinf(u) is u == +inf
template <typename T>
__device__ __forceinline__ T expm1_kahan(T x) {
  T u = exp(x);
  T um1 = u - T(1.0);
  return u == T(1.0)
             ? x
             : (um1 == T(-1.0) ? T(-1.0)
                               : (u == T(INFINITY) ? u : um1 * x / log(u)));
}

template <typename T>
__global__ void __launch_bounds__(128)
    p3_part2_kernel(Args<T> a, P3Consts c, long long n, double dt_d,
                    int ccn_const) {
#define K(x) static_cast<T>(x)
#define CBRT(x) pow((x), K(1.0 / 3.0))
  const T dt = K(dt_d);
  const T inv_dt = K(1.0 / dt_d);
  const T QS = K(c.qsmall);
  const T lv = K(c.lv), ls = K(c.ls), lf = K(c.lf);
  const T inv_cp = K(c.inv_cp);
  const T T0 = K(c.T_zerodegc);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const T* const* in = a.in;
    // 10 arguments
    const T pres = in[0][i], inv_exner = in[1][i], cld_frac_l = in[2][i],
            cld_frac_i = in[3][i], cld_frac_r = in[4][i], inv_cl = in[5][i],
            inv_ci = in[6][i], inv_cr = in[7][i], qv_prev = in[8][i],
            t_prev = in[9][i];
    // the 18 _PART2_ST_KEYS
    const T t = in[10][i], rho = in[11][i], inv_rho = in[12][i];
    T qv = in[13][i], th = in[14][i], qc = in[15][i], nc = in[16][i],
      qr = in[17][i], nr = in[18][i], qi = in[19][i], ni = in[20][i],
      qm = in[21][i], bm = in[22][i];
    const T qv_sat_l = in[23][i], qv_sat_i = in[24][i], sup_i = in[25][i],
            rhofaci = in[26][i], acn = in[27][i];
    // the 8 in-cloud ratios of part 1 (nc_in, nr_in and ni_in give way
    // to the table stage's nc_in_dsd, nr_in_t and ni_in_t)
    const T qc_in = in[28][i], qr_in = in[29][i], qi_in = in[30][i];
    T qm_in = in[31][i], bm_in = in[35][i];
    // the 27 _PART2_TV_NAMES (mu_r, cdist and cdist1 are not read)
    const T lamr = in[37][i], cdistr = in[38][i], logn0r = in[39][i],
            nr_in_dsd = in[40][i], nr_in = in[41][i];
    T ni_in = in[42][i];
    const T qm_in2 = in[43][i], bm_in2 = in[44][i],
            tv_qi_fallspd = in[45][i], tv_ni_selfcol = in[46][i],
            tv_qc2qi_col = in[47][i], tv_qi2qr_melt = in[48][i],
            tv_ni_lammax = in[49][i], tv_ni_lammin = in[50][i],
            tv_qi2qr_vent = in[51][i], tv_nr_col = in[52][i],
            tv_qr2qi_col = in[53][i], revap_val = in[54][i],
            nc_in = in[55][i], mu_c = in[56][i], lamc = in[57][i],
            gam_mur2 = in[60][i], gam_mur4 = in[61][i],
            gam_mur7 = in[62][i];

    // time/space physical variables (:3538-3585)
    const T mu = K(1.496e-6) * pow(t, K(1.5)) / (t + K(120.0));
    const T dv = K(8.794e-5) * pow(t, K(1.81)) / pres;
    const T sc = mu / (rho * dv);
    const T dum = K(1.0) / (K(c.rv) * t * t);
    const T dqsdt = lv * qv_sat_l * dum;
    const T dqsidt = ls * qv_sat_i * dum;
    const T ab = K(1.0) + dqsdt * lv * inv_cp;
    const T abi = K(1.0) + dqsidt * ls * inv_cp;
    const T kap = K(1.414e3) * mu;
    const T eii =
        t < K(253.15)
            ? K(0.001)
            : (t < K(273.15)
                   ? (t - K(253.15)) * K(0.3 - 0.001) / K(20.0) + K(0.001)
                   : K(0.3));

    // DSDs (:626-632), from the table stage
    nc = qc_in >= QS ? nc_in * cld_frac_l : nc;
    nr = qr_in >= QS ? nr_in_dsd * cld_frac_r : nr;

    const bool has_i = qi_in >= QS;
    const bool has_ir = has_i && (qr_in >= QS);
    qm_in = has_i ? qm_in2 : qm_in;
    bm_in = has_i ? bm_in2 : bm_in;
    qm = has_i ? qm_in * cld_frac_i : qm;
    bm = has_i ? bm_in * cld_frac_i : bm;
    // lambda limiters on ni (:677-678)
    ni_in = has_i ? tmin(ni_in, tv_ni_lammax * ni_in) : ni_in;
    ni_in = has_i ? tmax(ni_in, tv_ni_lammin * ni_in) : ni_in;

    const bool frz = t <= T0;
    // ice_cldliq_collection (:2054-2100)
    const bool both_ci = has_i && (qc_in >= QS);
    const T col_base = rhofaci * tv_qc2qi_col * K(c.eci) * rho * ni_in;
    T qccol = (both_ci && frz) ? col_base * qc_in : K(0.0);
    T nc_collect = both_ci ? col_base * nc_in : K(0.0);
    T qc2qr_ice_shed = (both_ci && !frz) ? col_base * qc_in : K(0.0);
    T ncshdc =
        (both_ci && !frz) ? qc2qr_ice_shed * K(c.inv_dropmass) : K(0.0);

    // ice_rain_collection (:2103-2157)
    const T base_r = rho * rhofaci * K(c.eri) * ni_in;
    T qrcol = (has_ir && frz)
                  ? pow(K(10.0), tv_qr2qi_col + logn0r) * base_r
                  : K(0.0);
    T nr_collect =
        has_ir ? pow(K(10.0), tv_nr_col + logn0r) * base_r : K(0.0);

    // ice_self_collection (:2159-2207)
    const T fr = qm_in / cmax(qi_in, K(1e-300));
    const T eii_fact =
        qm_in > K(0.0)
            ? (fr < K(0.6) ? K(1.0)
                           : (fr < K(0.9) ? K(1.0) - (fr - K(0.6)) / K(0.3)
                                          : K(0.0)))
            : K(1.0);
    T ni_selfcollect = has_i ? tv_ni_selfcol * rho * eii * eii_fact *
                                   rhofaci * ni_in * ni_in
                             : K(0.0);

    // ice_melting (:2211-2256)
    const T qsat0 = qv_sat_liq(T0, pres, c);
    const T vent = tv_qi2qr_melt +
                   tv_qi2qr_vent * CBRT(sc) * sqrt(rhofaci * rho / mu);
    const bool melt = has_i && (t > T0);
    T qi2qr_melt =
        melt ? cmax(vent * ((t - T0) * kap - rho * lv * dv * (qsat0 - qv)) *
                        K(2.0) * K(kPi) / lf * ni_in,
                    K(0.0))
             : K(0.0);
    T ni2nr_melt =
        melt ? qi2qr_melt * (ni_in / cmax(qi_in, K(1e-300))) : K(0.0);

    // ice_cldliq_wet_growth (:2259-2319)
    const bool wet_act = has_i && ((qc_in + qr_in) >= K(1e-6)) && (t < T0);
    const T qwgrth =
        wet_act ? cmax(vent * K(2.0) * K(kPi) *
                           (rho * lv * dv * (qsat0 - qv) - (t - T0) * kap) /
                           ((t - T0) * K(c.cpw) + lf) * ni_in,
                       K(0.0))
                : K(0.0);
    const T dum_w = cmax((qccol + qrcol) - qwgrth, K(0.0));
    const bool shed = wet_act && (dum_w >= K(1e-10));
    T nr_ice_shed = shed ? dum_w * K(1.923e6) : K(0.0);
    const bool big = shed && ((qccol + qrcol) >= K(1e-10));
    const T dum1_w = K(1.0) / cmax(qccol + qrcol, K(1e-300));
    qc2qr_ice_shed =
        big ? qc2qr_ice_shed + dum_w * qccol * dum1_w : qc2qr_ice_shed;
    qccol = big ? cmax(qccol - dum_w * qccol * dum1_w, K(0.0)) : qccol;
    qrcol = big ? cmax(qrcol - dum_w * qrcol * dum1_w, K(0.0)) : qrcol;
    const bool log_wetgrowth = shed;

    // calc_ice_relaxation_timescale (:2322-2355)
    const bool eps_act = has_i && (t < T0);
    const T epsi =
        eps_act ? vent * K(2.0) * K(kPi) * rho * dv * ni_in : K(0.0);
    const T epsi_tot = epsi;

    // calc_rime_density (:2413-2490)
    const bool rimed = (qccol >= QS) && (t < T0);
    const T vtrmi1 = rimed ? tv_qi_fallspd * rhofaci : K(0.0);
    const T iTc = K(1.0) / cmin(t - T0, K(-0.001));
    const T lamc_s = cmax(lamc, K(1e-300));
    const T vt_qc =
        acn * (mu_c + K(5.0)) * (mu_c + K(4.0)) / (lamc_s * lamc_s);
    const T d_c = (mu_c + K(4.0)) / lamc_s;
    const T v_imp = fabs(vtrmi1 - vt_qc);
    const T Ri = clip(d_c * K(-0.5e6) * v_imp * iTc, K(1.0), K(12.0));
    const T rho_rime_c =
        Ri <= K(8.0) ? (Ri * K(0.114) + K(0.051) - Ri * K(0.0055) * Ri) *
                           K(1000.0)
                     : (Ri - K(8.0)) * K(72.25) + K(611.0);
    const T rho_qm_cloud = (rimed && (qc_in >= QS)) ? rho_rime_c : K(400.0);

    // cldliq_immersion_freezing (:2504-2538)
    const bool imm_c = (qc_in >= QS) && (t <= K(c.T_rainfrz));
    const T dum_if = exp((T0 - t) * K(c.aimm));
    const T rl = K(1.0) / lamc_s;
    const T dum2_if = rl * rl * rl;
    const T poly6 = (mu_c + K(1.0)) * (mu_c + K(2.0)) * (mu_c + K(3.0)) *
                    (mu_c + K(4.0)) * (mu_c + K(5.0)) * (mu_c + K(6.0));
    const T poly3 = (mu_c + K(1.0)) * (mu_c + K(2.0)) * (mu_c + K(3.0));
    T qc2qi_hetero = imm_c ? nc_in * K(c.cons6) * poly6 * dum_if *
                                 (dum2_if * dum2_if)
                           : K(0.0);
    T nc2ni_immers =
        imm_c ? nc_in * K(c.cons5) * poly3 * dum_if * dum2_if : K(0.0);

    // rain_immersion_freezing (:2540-2573)
    const bool imm_r = (qr_in >= QS) && (t <= K(c.T_rainfrz));
    const T safe_l = cmax(lamr, K(1e-300));
    const T safe_cd = cmax(cdistr, K(1e-300));
    T qr2qi_immers =
        imm_r ? exp(log(safe_cd) + log(gam_mur7) - log(safe_l) * K(6.0)) *
                    K(c.cons6) * dum_if
              : K(0.0);
    T nr2ni_immers =
        imm_r ? exp(log(safe_cd) + log(gam_mur4) - log(safe_l) * K(3.0)) *
                    K(c.cons5) * dum_if
              : K(0.0);

    // rain evaporation (:2358-2410, 3383-3536)
    const bool has_r = qr_in >= QS;
    const T epsr =
        has_r ? cdistr * K(2.0 * kPi) * rho * dv *
                    (gam_mur2 * K(c.f1r) / safe_l +
                     sqrt(rho / mu) * K(c.f2r) * CBRT(sc) * revap_val)
              : K(0.0);

    const T ssat_r = qv - qv_sat_l;
    const T cld_frac = (qc_in + qi_in < K(1e-6)) ? K(0.0) : cld_frac_l;
    const bool evap_act = (cld_frac_r > cld_frac) && (ssat_r < K(0.0)) && has_r;
    const bool cold = t < K(273.15);
    const T ls_cp_dqsdt = dqsdt * K(c.ls * c.inv_cp) + K(1.0);
    T eps_eff = cold ? epsr + epsi_tot * ls_cp_dqsdt / abi : epsr;
    eps_eff = cmax(eps_eff, K(1e-20));
    const T tau_eff = K(1.0) / eps_eff;
    T A_c = (qv - qv_prev) * inv_dt - dqsdt * (t - t_prev) * inv_dt;
    A_c = cold ? A_c - (qv_sat_l - qv_sat_i) * ls_cp_dqsdt / abi * epsi_tot
               : A_c;
    const bool tiny_r = (qr_in < K(1e-12)) && (qv / qv_sat_l < K(0.999));
    const T dt_tau = (K(1.0) / tau_eff) * dt;
    const T tsw = -expm1_kahan(-dt_tau) / dt_tau;
    const T tau_r = K(1.0) / cmax(epsr, K(1e-300));
    const T equil = -A_c / ab * tau_eff / tau_r;
    const T instant = -ssat_r / (ab * tau_r);
    T qr2qv_evap =
        tiny_r ? qr_in * inv_dt : instant * tsw + equil * (K(1.0) - tsw);
    qr2qv_evap = tmin(qr2qv_evap, -ssat_r * inv_dt / ab);
    qr2qv_evap = cmax(qr2qv_evap, K(0.0));
    qr2qv_evap = tmin(qr2qv_evap, qr_in * inv_dt);
    qr2qv_evap =
        qr2qv_evap * (cld_frac_r - cld_frac) / cmax(cld_frac_r, K(c.mincld));
    qr2qv_evap = evap_act ? qr2qv_evap : K(0.0);
    T nr_evap =
        evap_act ? qr2qv_evap * (nr_in / cmax(qr_in, K(1e-300))) : K(0.0);

    // ice_deposition_sublimation (:3268-3333)
    const T qi_tend_ds = cmin(epsi / abi, inv_dt) * (qv - qv_sat_i);
    const bool has_i2 = qi_in > QS;
    T qi2qv_sublim =
        (has_i2 && (qi_tend_ds < K(0.0))) ? -qi_tend_ds : K(0.0);
    T ni_sublim = (has_i2 && (qi_tend_ds < K(0.0)))
                      ? qi2qv_sublim * (ni_in / cmax(qi_in, K(1e-300)))
                      : K(0.0);
    T qidep =
        (has_i2 && frz && (qi_tend_ds >= K(0.0))) ? qi_tend_ds : K(0.0);
    T qiberg = (has_i2 && frz)
                   ? cmax(epsi / abi * (qv_sat_l - qv_sat_i), K(0.0))
                   : K(0.0);

    // ice_nucleation (:2576-2618), Cooper 1986
    const bool nuc = (t < K(c.T_icenuc)) && (sup_i >= K(0.05));
    T dum_n = exp((T0 - t) * K(0.304)) * K(0.005) * K(1000.0) * inv_rho;
    dum_n = tmin(dum_n, inv_rho * K(100.0e3));
    const T N_nuc = cmax((dum_n - ni) * inv_dt, K(0.0));
    const T ni_nucleat = (nuc && (N_nuc >= K(1e-20))) ? N_nuc : K(0.0);
    T qinuc = (nuc && (N_nuc >= K(1e-20)))
                  ? cmax((dum_n - ni) * K(c.mi0) * inv_dt, K(0.0))
                  : K(0.0);

    // cloud_water_autoconversion (KK2000, :2750-2784)
    const bool autoc = qc_in >= K(1e-8);
    T qc2qr_auto = autoc ? pow(qc_in, K(2.47)) * K(1350.0) *
                               pow(nc_in * K(1e-6) * rho, K(-1.79))
                         : K(0.0);
    T ncautr = autoc ? qc2qr_auto * K(c.cons3) : K(0.0);
    T nc2nr_auto =
        autoc ? qc2qr_auto * nc_in / cmax(qc_in, K(1e-300)) : K(0.0);

    // droplet_self_collection (iparam=3 -> 0, :2646-2648)
    T nc_selfcollect = K(0.0);

    // cloud_rain_accretion (KK2000, :2689-2695)
    const bool accr = (qr_in >= QS) && (qc_in >= QS);
    T qc2qr_accret = accr ? pow(qc_in * qr_in, K(1.15)) * K(67.0) : K(0.0);
    T nc_accret =
        accr ? qc2qr_accret * nc_in / cmax(qc_in, K(1e-300)) : K(0.0);

    // rain_self_collection (:2705-2747)
    const bool rsc = qr_in >= QS;
    const T dum2_rsc =
        CBRT(qr_in / (cmax(nr_in, K(1e-300)) * K(kPi * c.rho_h2o)));
    const T dum_rsc = dum2_rsc < K(280e-6)
                          ? K(1.0)
                          : K(2.0) - exp((dum2_rsc - K(280e-6)) * K(2300.0));
    T nr_selfcollect =
        rsc ? dum_rsc * K(5.78) * nr_in * qr_in * rho : K(0.0);

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

    // conservation limiters (:3028-3102, 2957-3026, 2856-2955)
    {
      const T sinks = (qc2qr_auto + qc2qr_accret + qccol + qc2qi_hetero +
                       qc2qr_ice_shed + qiberg) *
                      dt;
      const bool lim = (sinks > qc) && (sinks >= K(1e-20));
      const T ratio = lim ? qc / cmax(sinks, K(1e-300)) : K(1.0);
      qc2qr_auto = qc2qr_auto * ratio;
      qc2qr_accret = qc2qr_accret * ratio;
      qccol = qccol * ratio;
      qc2qi_hetero = qc2qi_hetero * ratio;
      qc2qr_ice_shed = qc2qr_ice_shed * ratio;
      qiberg = qiberg * ratio;
      const bool liqpresent = qc > K(1e-20);
      qidep = liqpresent ? qidep * (K(1.0) - ratio) : qidep;
      qi2qv_sublim = liqpresent ? qi2qv_sublim * (K(1.0) - ratio)
                                : qi2qv_sublim;
    }
    {
      const T sinks = (qr2qv_evap + qrcol + qr2qi_immers) * dt;
      const T sources =
          (qc2qr_auto + qc2qr_accret + qi2qr_melt + qc2qr_ice_shed) * dt +
          qr;
      const bool lim = (sinks > sources) && (sinks >= K(1e-20));
      const T ratio = lim ? sources / cmax(sinks, K(1e-300)) : K(1.0);
      qr2qv_evap = qr2qv_evap * ratio;
      qrcol = qrcol * ratio;
      qr2qi_immers = qr2qi_immers * ratio;
    }
    {
      const T sinks = (qi2qv_sublim + qi2qr_melt) * dt;
      const T sources = (qidep + qinuc + qrcol + qccol + qr2qi_immers +
                         qc2qi_hetero + qiberg) *
                            dt +
                        qi;
      const bool lim = (sinks > sources) && (sinks >= K(1e-20));
      const T ratio = lim ? sources / cmax(sinks, K(1e-300)) : K(1.0);
      qi2qv_sublim = qi2qv_sublim * ratio;
      qi2qr_melt = qi2qr_melt * ratio;
    }
    {
      const T sink_nc =
          (nc_collect + nc2ni_immers + nc_accret + nc2nr_auto) * dt;
      const T source_nc = nc_selfcollect * dt + nc;
      const T ratio =
          sink_nc > source_nc ? source_nc / cmax(sink_nc, K(1e-300)) : K(1.0);
      nc_collect = nc_collect * ratio;
      nc2ni_immers = nc2ni_immers * ratio;
      nc_accret = nc_accret * ratio;
      nc2nr_auto = nc2nr_auto * ratio;
    }
    {
      const T sink_nr =
          (nr_collect + nr2ni_immers + nr_selfcollect + nr_evap) * dt;
      const T source_nr = (ni2nr_melt * K(c.nmltratio) + nr_ice_shed +
                           ncshdc + nc2nr_auto) *
                              dt +
                          nr;
      const T ratio =
          sink_nr > source_nr ? source_nr / cmax(sink_nr, K(1e-300)) : K(1.0);
      nr_collect = nr_collect * ratio;
      nr2ni_immers = nr2ni_immers * ratio;
      nr_selfcollect = nr_selfcollect * ratio;
      nr_evap = nr_evap * ratio;
    }
    {
      const T sink_ni = (ni2nr_melt + ni_sublim + ni_selfcollect) * dt;
      const T source_ni =
          (ni_nucleat + nr2ni_immers + nc2ni_immers) * dt + ni;
      const T ratio =
          sink_ni > source_ni ? source_ni / cmax(sink_ni, K(1e-300)) : K(1.0);
      ni2nr_melt = ni2nr_melt * ratio;
      ni_sublim = ni_sublim * ratio;
      ni_selfcollect = ni_selfcollect * ratio;
    }

    // ice_supersat_conservation (:2856-2886)
    {
      const T qv_sink = qidep + qinuc;
      const bool act = (qv_sink > QS) && (cld_frac_i > K(1e-20));
      T qv_avail = (qv + (qi2qv_sublim + qr2qv_evap) * dt - qv_sat_i) /
                   (K(c.ls * c.ls) * qv_sat_i / (K(c.cp * c.rv) * t * t) +
                    K(1.0)) /
                   dt;
      qv_avail = cmax(qv_avail, K(0.0));
      const T fract = (act && (qv_sink > qv_avail))
                          ? qv_avail / cmax(qv_sink, K(1e-300))
                          : K(1.0);
      qinuc = qinuc * fract;
      qidep = qidep * fract;
    }

    // prevent_liq_supersaturation (:2888-2955)
    {
      const T qv_sources = qi2qv_sublim + qr2qv_evap;
      const T qv_sinks = qidep + qinuc;
      const T T_end =
          t + ((qv_sinks - qi2qv_sublim) * ls * inv_cp -
               qr2qv_evap * lv * inv_cp) *
                  dt;
      const T qsl = qv_sat_liq(T_end, pres, c);
      const T A = lv * qsl * dt * inv_cp / (K(c.rv) * T_end * T_end) *
                  (ls * qi2qv_sublim + lv * qr2qv_evap);
      T frac = (qsl - qv + qv_sinks * dt + A) /
               cmax(qv_sources * dt + A, K(1e-300));
      frac = clip(frac, K(0.0), K(1.0));
      frac = qv_sources < QS ? K(0.0) : frac;
      qi2qv_sublim = qv_sources >= QS ? frac * qi2qv_sublim : qi2qv_sublim;
      qr2qv_evap = qv_sources >= QS ? frac * qr2qv_evap : qr2qv_evap;
    }

    // update_prognostic_ice (:3105-3214)
    qc = qc + (-qc2qi_hetero - qccol - qc2qr_ice_shed - qiberg) * dt;
    if (!ccn_const) nc = nc + (-nc_collect - nc2ni_immers) * dt;
    qr = qr + (-qrcol + qi2qr_melt - qr2qi_immers + qc2qr_ice_shed) * dt;
    nr = nr + (-nr_collect - nr2ni_immers + ni2nr_melt * K(c.nmltratio) +
               nr_ice_shed + ncshdc) *
                  dt;
    {
      const bool has_qi = qi >= QS;
      const T decay = (qi2qv_sublim + qi2qr_melt) / cmax(qi, K(1e-300)) * dt;
      bm = has_qi ? bm - decay * bm : bm;
      qm = has_qi ? qm - decay * qm : qm;
      qi = has_qi ? qi - (qi2qv_sublim + qi2qr_melt) * dt : qi;
    }
    const T dum_i = (qrcol + qccol + qr2qi_immers + qc2qi_hetero) * dt;
    qi = qi + (qidep + qinuc + qiberg) * dt + dum_i;
    qm = qm + dum_i;
    bm = bm + (qrcol * K(c.inv_rho_rimeMax) + qccol / rho_qm_cloud +
               (qr2qi_immers + qc2qi_hetero) * K(c.inv_rho_rimeMax)) *
                  dt;
    ni = ni + (ni_nucleat - ni2nr_melt - ni_sublim - ni_selfcollect +
               nr2ni_immers + nc2ni_immers) *
                  dt;
    if (qm < K(0.0)) {
      qm = K(0.0);
      bm = K(0.0);
    }
    qm = log_wetgrowth ? qi : qm;
    bm = log_wetgrowth ? qm * K(c.inv_rho_rimeMax) : bm;
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
      nc = K(c.nccnst) * inv_rho;
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
    const T liq_ice_exchange = qc2qi_hetero + qr2qi_immers - qi2qr_melt +
                               qiberg + qccol + qrcol;

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
    {
      // impose_max_total_ni(ni / max(cld_frac_i, mincld), inv_rho)
      const T nic = ni / cmax(cld_frac_i, K(c.mincld));
      const T d = K(c.max_total_ni) * inv_rho / cmax(nic, K(1e-300));
      ni = (nic >= K(1e-20) ? nic * cmin(d, K(1.0)) : nic) * cld_frac_i;
    }

    // incloud_ratios (micro_p3_utils.F90:237-295)
    const bool okc = qc >= QS, oki = qi >= QS, okr = qr >= QS;
    const bool okm = (qm >= QS) && oki;
    const T o_qc_in = cmin(okc ? qc * inv_cl : K(0.0), K(c.incloud_limit));
    const T o_nc_in = okc ? cmax(nc * inv_cl, K(0.0)) : K(0.0);
    const T o_qi_in = cmin(oki ? qi * inv_ci : K(0.0), K(c.incloud_limit));
    const T o_ni_in = oki ? cmax(ni * inv_ci, K(0.0)) : K(0.0);
    const T o_qm_in = okm ? qm * inv_ci : K(0.0);
    const T o_bm_in =
        cmin(okm ? cmax(bm * inv_cl, K(0.0)) : K(0.0), K(c.incloud_limit));
    const T o_qr_in = cmin(okr ? qr * inv_cr : K(0.0), K(c.precip_limit));
    const T o_nr_in = okr ? cmax(nr * inv_cr, K(0.0)) : K(0.0);

    // the 12 _PART2_OUT_KEYS, the 8 in-cloud ratios, the 7 diagnostics
    T* const* out = a.out;
    out[0][i] = qv;
    out[1][i] = th;
    out[2][i] = qc;
    out[3][i] = nc;
    out[4][i] = qr;
    out[5][i] = nr;
    out[6][i] = qi;
    out[7][i] = ni;
    out[8][i] = qm;
    out[9][i] = bm;
    out[10][i] = mu_c;
    out[11][i] = lamc;
    out[12][i] = o_qc_in;
    out[13][i] = o_qr_in;
    out[14][i] = o_qi_in;
    out[15][i] = o_qm_in;
    out[16][i] = o_nc_in;
    out[17][i] = o_nr_in;
    out[18][i] = o_ni_in;
    out[19][i] = o_bm_in;
    out[20][i] = qv2qi_depos_tend;
    out[21][i] = precip_total_tend;
    out[22][i] = nevapr;
    out[23][i] = qr2qv_evap;
    out[24][i] = vap_liq_exchange;
    out[25][i] = qv2qi_depos_tend;
    out[26][i] = liq_ice_exchange;
  }
#undef CBRT
#undef K
}

template <typename T>
int launch(const unsigned long long* ins, const unsigned long long* outs,
           long long n, double dt, int ccn_const, const double* consts,
           void* stream) {
  Args<T> a;
  for (int k = 0; k < NIN; ++k) a.in[k] = reinterpret_cast<const T*>(ins[k]);
  for (int k = 0; k < NOUT; ++k) a.out[k] = reinterpret_cast<T*>(outs[k]);
  P3Consts c;
  memcpy(&c, consts, sizeof(P3Consts));
  if (n <= 0) return 0;
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  p3_part2_kernel<T><<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, c, n, dt,
                                                            ccn_const);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pam_p3_part2_f32(const unsigned long long* ins,
                     const unsigned long long* outs, long long n, double dt,
                     int ccn_const, const double* consts, void* stream) {
  return launch<float>(ins, outs, n, dt, ccn_const, consts, stream);
}

int pam_p3_part2_f64(const unsigned long long* ins,
                     const unsigned long long* outs, long long n, double dt,
                     int ccn_const, const double* consts, void* stream) {
  return launch<double>(ins, outs, n, dt, ccn_const, consts, stream);
}

int pam_p3_part2_layout() { return NIN * 10000 + NOUT * 100 + NCONST; }

}  // extern "C"
