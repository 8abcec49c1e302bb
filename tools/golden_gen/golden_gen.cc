// Golden-vector generator: compiles the reference PHY (/root/reference, in
// place) and dumps exact intermediate/final arrays for parity testing of the
// JAX reimplementation. Output: tests/golden/<name>.bin (raw little-endian)
// plus tests/golden/meta.json describing shapes/dtypes.
//
// Nothing from the reference is copied into the repo; this tool links against
// it read-only and dumps *data*.
// Pre-include all stdlib headers the reference pulls in, so the
// private-exposing define below never touches libstdc++ internals.
#include <iostream>
#include <iomanip>
#include <sstream>
#include <complex>
#include <atomic>
#include <cmath>
#include <cstring>
#include <string>
#include <vector>
// Test harness only: expose private members (FIR taps, LDPC tables) for dumping.
#define private public
#include "physical_layer/telecom_system.h"
#undef private
#include "physical_layer/mercury_normal_1_16.h"
#include "physical_layer/mercury_normal_2_16.h"
#include "physical_layer/mercury_normal_3_16.h"
#include "physical_layer/mercury_normal_4_16.h"
#include "physical_layer/mercury_normal_5_16.h"
#include "physical_layer/mercury_normal_6_16.h"
#include "physical_layer/mercury_normal_8_16.h"
#include "physical_layer/mercury_normal_14_16.h"
#include "common/os_interop.h"

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <complex>

extern double carrier_frequency_offset;  // defined in stubs.cc

static std::string g_outdir;
static FILE *g_meta;
static bool g_meta_first = true;

static void meta_entry(const std::string &name, const std::string &dtype,
                       const std::vector<long> &shape) {
  if (!g_meta_first) fprintf(g_meta, ",\n");
  g_meta_first = false;
  fprintf(g_meta, "  \"%s\": {\"dtype\": \"%s\", \"shape\": [", name.c_str(), dtype.c_str());
  for (size_t i = 0; i < shape.size(); i++)
    fprintf(g_meta, "%s%ld", i ? ", " : "", shape[i]);
  fprintf(g_meta, "]}");
}

template <typename T>
static void dump(const std::string &name, const T *data, const std::vector<long> &shape,
                 const char *dtype) {
  long n = 1;
  for (long s : shape) n *= s;
  std::string path = g_outdir + "/" + name + ".bin";
  FILE *f = fopen(path.c_str(), "wb");
  if (!f) { fprintf(stderr, "cannot open %s\n", path.c_str()); exit(1); }
  fwrite(data, sizeof(T), n, f);
  fclose(f);
  meta_entry(name, dtype, shape);
}

static void dump_i32(const std::string &name, const int *d, std::vector<long> s) { dump(name, d, s, "int32"); }
static void dump_f64(const std::string &name, const double *d, std::vector<long> s) { dump(name, d, s, "float64"); }
static void dump_c128(const std::string &name, const std::complex<double> *d, std::vector<long> s) { dump(name, d, s, "complex128"); }
static void dump_f32(const std::string &name, const float *d, std::vector<long> s) { dump(name, d, s, "float32"); }

static void dump_scalar(const std::string &name, double v) {
  dump_f64(name, &v, {1});
}

// ---------------------------------------------------------------------------
static void dump_prng() {
  std::vector<int> out(2000);
  for (int seed : {0, 1, 42}) {
    __srandom(seed);
    for (int i = 0; i < 2000; i++) out[i] = (int)__random();
    dump_i32("prng_seed" + std::to_string(seed), out.data(), {2000});
  }
}

static void dump_ldpc_tables() {
  struct Tbl { const char *tag; int K; int Cw, Vw, dw; int *C, *V, *E, *d; long P; };
  Tbl tbls[] = {
    {"1_16", 100, mercury_normal_Cwidth_1_16, mercury_normal_Vwidth_1_16, mercury_normal_dwidth_1_16,
     &mercury_normal_QCmatrixC_1_16[0][0], &mercury_normal_QCmatrixV_1_16[0][0],
     &mercury_normal_QCmatrixEnc_1_16[0][0], &mercury_normal_QCmatrixd_1_16[0], 1500},
    {"2_16", 200, mercury_normal_Cwidth_2_16, mercury_normal_Vwidth_2_16, mercury_normal_dwidth_2_16,
     &mercury_normal_QCmatrixC_2_16[0][0], &mercury_normal_QCmatrixV_2_16[0][0],
     &mercury_normal_QCmatrixEnc_2_16[0][0], &mercury_normal_QCmatrixd_2_16[0], 1400},
    {"3_16", 300, mercury_normal_Cwidth_3_16, mercury_normal_Vwidth_3_16, mercury_normal_dwidth_3_16,
     &mercury_normal_QCmatrixC_3_16[0][0], &mercury_normal_QCmatrixV_3_16[0][0],
     &mercury_normal_QCmatrixEnc_3_16[0][0], &mercury_normal_QCmatrixd_3_16[0], 1300},
    {"4_16", 400, mercury_normal_Cwidth_4_16, mercury_normal_Vwidth_4_16, mercury_normal_dwidth_4_16,
     &mercury_normal_QCmatrixC_4_16[0][0], &mercury_normal_QCmatrixV_4_16[0][0],
     &mercury_normal_QCmatrixEnc_4_16[0][0], &mercury_normal_QCmatrixd_4_16[0], 1200},
    {"5_16", 500, mercury_normal_Cwidth_5_16, mercury_normal_Vwidth_5_16, mercury_normal_dwidth_5_16,
     &mercury_normal_QCmatrixC_5_16[0][0], &mercury_normal_QCmatrixV_5_16[0][0],
     &mercury_normal_QCmatrixEnc_5_16[0][0], &mercury_normal_QCmatrixd_5_16[0], 1100},
    {"6_16", 600, mercury_normal_Cwidth_6_16, mercury_normal_Vwidth_6_16, mercury_normal_dwidth_6_16,
     &mercury_normal_QCmatrixC_6_16[0][0], &mercury_normal_QCmatrixV_6_16[0][0],
     &mercury_normal_QCmatrixEnc_6_16[0][0], &mercury_normal_QCmatrixd_6_16[0], 1000},
    {"8_16", 800, mercury_normal_Cwidth_8_16, mercury_normal_Vwidth_8_16, mercury_normal_dwidth_8_16,
     &mercury_normal_QCmatrixC_8_16[0][0], &mercury_normal_QCmatrixV_8_16[0][0],
     &mercury_normal_QCmatrixEnc_8_16[0][0], &mercury_normal_QCmatrixd_8_16[0], 800},
    {"14_16", 1400, mercury_normal_Cwidth_14_16, mercury_normal_Vwidth_14_16, mercury_normal_dwidth_14_16,
     &mercury_normal_QCmatrixC_14_16[0][0], &mercury_normal_QCmatrixV_14_16[0][0],
     &mercury_normal_QCmatrixEnc_14_16[0][0], &mercury_normal_QCmatrixd_14_16[0], 200},
  };
  for (auto &t : tbls) {
    std::string p = std::string("ldpc_") + t.tag + "_";
    int dims[4] = {t.Cw, t.Vw, t.dw, t.K};
    dump_i32(p + "dims", dims, {4});
    dump_i32(p + "C", t.C, {t.P, t.Cw});
    dump_i32(p + "V", t.V, {1600, t.Vw});
    dump_i32(p + "Enc", t.E, {t.P, t.Cw - 1});
    dump_i32(p + "d", t.d, {t.dw});
  }
}

// Fill deterministic payload bits via the reference PRNG (seed 42).
static void fill_payload_bits(int *bits, int n) {
  __srandom(42);
  for (int i = 0; i < n; i++) bits[i] = (int)(__random() % 2);
}

static void dump_config(cl_telecom_system &ts, int cfg, const std::string &tag) {
  ts.load_configuration(cfg);
  cl_data_container &dc = ts.data_container;
  cl_ofdm &ofdm = ts.ofdm;

  std::string p = "cfg" + tag + "_";

  // --- geometry / parameters
  {
    int g[] = {
      (int)ts.M, dc.Nc, dc.Nfft, dc.Nofdm, dc.Ngi, dc.Nsymb, dc.preamble_nSymb,
      dc.nData, dc.nBits, dc.buffer_Nsymb, dc.interpolation_rate, dc.total_frame_size,
      ofdm.pilot_configurator.Dx, ofdm.pilot_configurator.Dy,
      ofdm.pilot_configurator.nPilots, ofdm.pilot_configurator.nData, ofdm.pilot_configurator.nConfig,
      ts.ldpc.N, ts.ldpc.K, ts.ldpc.P,
      ts.bit_interleaver_block_size, ts.time_freq_interleaver_block_size,
      ofdm.channel_estimator, ofdm.channel_estimator_amplitude_restoration,
      ofdm.LS_window_width, ofdm.LS_window_hight, ofdm.time_sync_Nsymb,
      ts.outer_code_reserved_bits, ofdm.start_shift,
      ofdm.preamble_configurator.Nsymb, ofdm.preamble_configurator.nPreamble, ofdm.preamble_configurator.nZeros,
    };
    dump_i32(p + "geom", g, {(long)(sizeof(g) / sizeof(int))});
    double d[] = {ts.bandwidth, ts.sampling_frequency, ts.carrier_frequency,
                  ts.carrier_amplitude, ts.LDPC_real_CR, ts.Tu, ts.Ts, ts.Tf, ts.rb, ts.rbc,
                  ofdm.pilot_configurator.boost, ofdm.preamble_configurator.boost,
                  ts.output_power_Watt, ofdm.preamble_papr_cut, ofdm.data_papr_cut};
    dump_f64(p + "params", d, {(long)(sizeof(d) / sizeof(double))});
  }

  // --- frame type map + pilot sequence + preamble
  {
    std::vector<int> types(dc.Nsymb * dc.Nc);
    for (int i = 0; i < dc.Nsymb * dc.Nc; i++) types[i] = ofdm.ofdm_frame[i].type;
    dump_i32(p + "frame_types", types.data(), {dc.Nsymb, dc.Nc});

    int npil = ofdm.pilot_configurator.nPilots;
    dump_c128(p + "pilot_seq", ofdm.pilot_configurator.sequence, {npil});

    int pre_n = ofdm.preamble_configurator.Nsymb;
    std::vector<std::complex<double>> pre(pre_n * dc.Nc);
    std::vector<int> pre_types(pre_n * dc.Nc);
    for (int i = 0; i < pre_n * dc.Nc; i++) {
      pre[i] = ofdm.ofdm_preamble[i].value;
      pre_types[i] = ofdm.ofdm_preamble[i].type;
    }
    dump_c128(p + "preamble_vals", pre.data(), {pre_n, dc.Nc});
    dump_i32(p + "preamble_types", pre_types.data(), {pre_n, dc.Nc});
  }

  // --- dispersal sequence
  dump_i32(p + "dispersal", dc.bit_energy_dispersal_sequence, {ts.ldpc.N});

  // --- FIR coefficients
  dump_f64(p + "fir_rx_data", ofdm.FIR_rx_data.filter_coefficients, {ofdm.FIR_rx_data.filter_nTaps});
  dump_f64(p + "fir_rx_ts", ofdm.FIR_rx_time_sync.filter_coefficients, {ofdm.FIR_rx_time_sync.filter_nTaps});
  dump_f64(p + "fir_tx1", ofdm.FIR_tx1.filter_coefficients, {ofdm.FIR_tx1.filter_nTaps});
  dump_f64(p + "fir_tx2", ofdm.FIR_tx2.filter_coefficients, {ofdm.FIR_tx2.filter_nTaps});

  // --- pre-equalization channel
  if ((int)ts.M != MOD_MFSK) {
    std::vector<std::complex<double>> pe(dc.Nc);
    for (int i = 0; i < dc.Nc; i++) pe[i] = ts.pre_equalization_channel[i].value;
    dump_c128(p + "pre_eq", pe.data(), {dc.Nc});
  }

  // --- TX golden: payload -> passband (unfiltered + filtered)
  int nReal = dc.nBits - ts.ldpc.P;
  int frame_bytes = (nReal - ts.outer_code_reserved_bits) / 8;
  std::vector<int> payload_bytes(frame_bytes + 2);
  {
    std::vector<int> bits(frame_bytes * 8);
    fill_payload_bits(bits.data(), frame_bytes * 8);
    bit_to_byte(bits.data(), payload_bytes.data(), frame_bytes * 8);
    dump_i32(p + "payload_bytes", payload_bytes.data(), {frame_bytes});
  }

  ofdm.passband_start_sample = 0;  // deterministic carrier phase
  ts.transmit_byte(payload_bytes.data(), frame_bytes, dc.passband_data, NO_FILTER_MESSAGE);
  dump_f64(p + "tx_passband_nofilter", dc.passband_data, {dc.total_frame_size});

  ofdm.passband_start_sample = 0;
  ts.transmit_byte(payload_bytes.data(), frame_bytes, dc.passband_data, SINGLE_MESSAGE);
  dump_f64(p + "tx_passband_single", dc.passband_data, {dc.total_frame_size});

  // --- LDPC encode golden (bit level: post-dispersal codeword)
  {
    std::vector<int> bits(N_MAX, 0), enc(N_MAX, 0);
    fill_payload_bits(bits.data(), ts.ldpc.K);
    ts.ldpc.encode(bits.data(), enc.data());
    dump_i32(p + "ldpc_in", bits.data(), {ts.ldpc.K});
    dump_i32(p + "ldpc_enc", enc.data(), {ts.ldpc.N});
  }

  // --- RX golden: put SINGLE_MESSAGE frame into a buffer with delay + light noise
  {
    int interp = dc.interpolation_rate;
    long buf_n = (long)dc.Nofdm * dc.buffer_Nsymb * interp;
    int delay = ((dc.preamble_nSymb + 2) * dc.Nofdm + 50) * interp;
    srand(1234);
    ts.awgn_channel.apply_with_delay(dc.passband_data, dc.passband_delayed_data,
                                     0.02f, dc.total_frame_size, delay);
    // zero-fill the tail beyond delay+frame
    for (long i = delay + dc.total_frame_size; i < buf_n; i++)
      dc.passband_delayed_data[i] = 0.0;
    dump_f64(p + "rx_buffer", dc.passband_delayed_data, {buf_n});
    std::vector<int> out_bytes(N_MAX, 0);
    if ((int)ts.M == MOD_MFSK) ts.mfsk_fixed_delay = delay;
    st_receive_stats st = ts.receive_byte(dc.passband_delayed_data, out_bytes.data());
    int rx_geom[] = {st.message_decoded, st.delay, st.crc, st.all_zeros, st.iterations_done, delay};
    dump_i32(p + "rx_stats", rx_geom, {6});
    dump_i32(p + "rx_bytes", out_bytes.data(), {frame_bytes});
    double snr[] = {st.SNR, st.freq_offset};
    dump_f64(p + "rx_snr", snr, {2});
  }

  // --- MFSK-specific tables
  if ((int)ts.M == MOD_MFSK) {
    int m[] = {ts.mfsk.M, ts.mfsk.nBits, ts.mfsk.nStreams, ts.mfsk.tone_hop_step,
               ts.mfsk.preamble_nSymb, ts.ctrl_nBits, ts.ctrl_nsymb};
    dump_i32(p + "mfsk_geom", m, {7});
    dump_i32(p + "mfsk_stream_offsets", ts.mfsk.stream_offsets, {ts.mfsk.nStreams});
    dump_i32(p + "mfsk_preamble_tones", ts.mfsk.preamble_tones, {ts.mfsk.preamble_nSymb});
    dump_i32(p + "mfsk_ack_tones", ts.mfsk.ack_tones, {8});
    dump_i32(p + "mfsk_break_tones", ts.mfsk.break_tones, {8});
  }
}

int main(int argc, char **argv) {
  if (argc < 2) { fprintf(stderr, "usage: golden_gen <outdir> [cfg...] | ber <cfg> <esn0> <nframes>\n"); return 1; }

  // ACK-pattern detection sweep (reference's own self-test).
  if (std::string(argv[1]) == "acktest" && argc >= 3) {
    static cl_telecom_system ts;
    ts.operation_mode = ARQ_MODE;
    ts.load_configuration(atoi(argv[2]));
    ts.ack_pattern_detection_test();
    return 0;
  }

  // RX throughput mode: time the reference receive_byte on this host CPU.
  if (std::string(argv[1]) == "rxbench" && argc >= 4) {
    static cl_telecom_system ts;
    ts.operation_mode = ARQ_MODE;
    int cfg = atoi(argv[2]);
    int reps = atoi(argv[3]);
    ts.load_configuration(cfg);
    cl_data_container &dc = ts.data_container;
    int nReal = dc.nBits - ts.ldpc.P;
    int frame_bytes = (nReal - ts.outer_code_reserved_bits) / 8;
    std::vector<int> payload(frame_bytes + 2, 0x5A);
    ts.ofdm.passband_start_sample = 0;
    ts.transmit_byte(payload.data(), frame_bytes, dc.passband_data, SINGLE_MESSAGE);
    long buf_n = (long)dc.Nofdm * dc.buffer_Nsymb * dc.interpolation_rate;
    int delay = ((dc.preamble_nSymb + 2) * dc.Nofdm + 50) * dc.interpolation_rate;
    srand(7);
    ts.awgn_channel.apply_with_delay(dc.passband_data, dc.passband_delayed_data,
                                     0.05f, dc.total_frame_size, delay);
    for (long i = delay + dc.total_frame_size; i < buf_n; i++)
      dc.passband_delayed_data[i] = 0.0;
    std::vector<int> out_bytes(N_MAX, 0);
    auto t0 = std::chrono::steady_clock::now();
    int decoded = 0;
    for (int r = 0; r < reps; r++) {
      st_receive_stats st = ts.receive_byte(dc.passband_delayed_data, out_bytes.data());
      decoded += (st.message_decoded == YES);
    }
    double secs = std::chrono::duration<double>(
        std::chrono::steady_clock::now() - t0).count();
    printf("RXBENCH cfg=%d reps=%d decoded=%d secs=%.3f samples_per_s=%.0f\n",
           cfg, reps, decoded, secs, (double)reps * buf_n / secs);
    return 0;
  }

  // Baseband BER oracle: the reference's own baseband Monte-Carlo test
  // (telecom_system.cc baseband_test_EsN0 — no sync/preamble/CRC; clean
  // per-carrier Es/N0 convention). Used to pin down which convention the
  // documented Es/N0@FER<0.1 table (common_defines.h:129-148) is in.
  if (std::string(argv[1]) == "berbb" && argc >= 5) {
    static cl_telecom_system ts;
    ts.operation_mode = ARQ_MODE;
    int cfg = atoi(argv[2]);
    float esn0 = atof(argv[3]);
    int nframes = atoi(argv[4]);
    ts.load_configuration(cfg);
    cl_error_rate er = ts.baseband_test_EsN0(esn0, nframes);
    printf("BERBB_RESULT cfg=%d esn0=%.2f frames=%.0f ferrors=%.0f fer=%.4f ber=%.6f\n",
           cfg, esn0, er.Frames_total, er.Error_frames_total,
           er.Error_frames_total / er.Frames_total,
           er.Error_bits_total / er.Bits_total);
    return 0;
  }

  // Punctured-LDPC BER oracle: the reference's own punctured BER test
  // (main.cc:312-318 `-P` -> test_puncture_nBits; LLRs past the puncture
  // point zeroed at telecom_system.cc:1184-1189). Measures whether the
  // REFERENCE BUILD itself holds its documented "same waterfall as full
  // frame" claim (telecom_system.cc:2968-2972) for the MFSK ctrl sizes.
  if (std::string(argv[1]) == "berctrl" && argc >= 6) {
    static cl_telecom_system ts;
    ts.operation_mode = ARQ_MODE;
    int cfg = atoi(argv[2]);
    float esn0 = atof(argv[3]);
    int nframes = atoi(argv[4]);
    ts.load_configuration(cfg);
    ts.test_puncture_nBits = atoi(argv[5]);
    cl_error_rate er = ts.passband_test_EsN0(esn0, nframes);
    printf("BERCTRL_RESULT cfg=%d punct=%d esn0=%.2f frames=%.0f ferrors=%.0f fer=%.4f ber=%.6f\n",
           cfg, ts.test_puncture_nBits, esn0, er.Frames_total,
           er.Error_frames_total,
           er.Error_frames_total / er.Frames_total,
           er.Error_bits_total / er.Bits_total);
    return 0;
  }

  // BER harness mode: run the reference's own passband Monte-Carlo test.
  if (std::string(argv[1]) == "ber" && argc >= 5) {
    static cl_telecom_system ts;
    ts.operation_mode = ARQ_MODE;
    int cfg = atoi(argv[2]);
    float esn0 = atof(argv[3]);
    int nframes = atoi(argv[4]);
    ts.load_configuration(cfg);
    cl_error_rate er = ts.passband_test_EsN0(esn0, nframes);
    printf("BER_RESULT cfg=%d esn0=%.2f frames=%.0f ferrors=%.0f fer=%.4f ber=%.6f\n",
           cfg, esn0, er.Frames_total, er.Error_frames_total,
           er.Error_frames_total / er.Frames_total,
           er.Error_bits_total / er.Bits_total);
    return 0;
  }
  g_outdir = argv[1];
  // low-density mode: `golden_gen <outdir> low [cfg...]` dumps the same
  // per-config vectors with LOW_DENSITY pilots under a `cfg<N>ld_` prefix
  // into meta_low.json (reference density tables: telecom_system.cc:1818-1876)
  bool low_density = (argc > 2 && std::string(argv[2]) == "low");
  // sbitx mode: `golden_gen <outdir> sbitx [cfg...]` dumps the same vectors
  // with the sBitx +15 kHz carrier shift (reference main.cc:200-218,
  // physical_config.cc:88) under a `cfg<N>sb_` prefix into meta_sbitx.json
  bool sbitx = (argc > 2 && std::string(argv[2]) == "sbitx");
  int first_cfg_arg = (low_density || sbitx) ? 3 : 2;
  std::string meta_path = g_outdir + (low_density ? "/meta_low.json"
                                      : sbitx ? "/meta_sbitx.json"
                                              : "/meta.json");
  g_meta = fopen(meta_path.c_str(), "w");
  fprintf(g_meta, "{\n");

  if (!low_density && !sbitx) {
    dump_prng();
    dump_ldpc_tables();
  }
  if (sbitx)
    carrier_frequency_offset = 15000.0;

  static cl_telecom_system ts;
  ts.operation_mode = ARQ_MODE; // suppress pilot print
  if (low_density)
    ts.default_configurations_telecom_system.ofdm_pilot_density = LOW_DENSITY;

  std::vector<int> cfgs;
  if (argc > first_cfg_arg) {
    for (int i = first_cfg_arg; i < argc; i++) cfgs.push_back(atoi(argv[i]));
  } else {
    for (int c = 0; c <= 16; c++) cfgs.push_back(c);
    cfgs.push_back(100); cfgs.push_back(101); cfgs.push_back(102);
  }
  for (int c : cfgs) {
    fprintf(stderr, "=== config %d%s ===\n", c, low_density ? " (low density)" : "");
    dump_config(ts, c, std::to_string(c) + (low_density ? "ld" : sbitx ? "sb" : ""));
  }

  fprintf(g_meta, "\n}\n");
  fclose(g_meta);
  fprintf(stderr, "golden vectors written to %s\n", g_outdir.c_str());
  return 0;
}
