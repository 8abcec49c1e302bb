// Link-layer golden generator: drives the REFERENCE's own ARQ
// serialization code (cl_arq_controller::send / add_message_control,
// arq_common.cc:2025-2102, arq_commander.cc:287-369) and dumps the exact
// wire bytes (and one passband frame) so this repo can prove byte
// interop against the reference binary rather than against its own
// re-reading of the spec.
//
// Like golden_gen.cc, the reference at /root/reference is compiled in
// place (read-only); nothing is copied. Output: tests/golden/link_*.bin +
// meta entries in tests/golden/meta_link.json.
#include <iostream>
#include <iomanip>
#include <sstream>
#include <complex>
#include <atomic>
#include <cmath>
#include <cstring>
#include <string>
#include <vector>
// Test harness only: reach private ARQ members (message buffers, config
// fields) to stage deterministic protocol states.
#define private public
#include "physical_layer/telecom_system.h"
#include "datalink_layer/arq.h"
#undef private
#include "common/ring_buffer_posix.h"

#include <cstdio>
#include <cstdlib>

static std::string g_outdir;
static FILE *g_meta;
static bool g_meta_first = true;

static void meta_entry(const std::string &name, const std::string &dtype,
                       const std::vector<long> &shape) {
  if (!g_meta_first) fprintf(g_meta, ",\n");
  g_meta_first = false;
  fprintf(g_meta, "  \"%s\": {\"dtype\": \"%s\", \"shape\": [", name.c_str(),
          dtype.c_str());
  for (size_t i = 0; i < shape.size(); i++)
    fprintf(g_meta, "%s%ld", i ? ", " : "", shape[i]);
  fprintf(g_meta, "]}");
}

static void dump_u8(const std::string &name, const unsigned char *d, long n) {
  std::string path = g_outdir + "/" + name + ".bin";
  FILE *f = fopen(path.c_str(), "wb");
  if (!f) { fprintf(stderr, "cannot open %s\n", path.c_str()); exit(1); }
  fwrite(d, 1, n, f);
  fclose(f);
  meta_entry(name, "uint8", {n});
}

static void dump_f64(const std::string &name, const double *d, long n) {
  std::string path = g_outdir + "/" + name + ".bin";
  FILE *f = fopen(path.c_str(), "wb");
  if (!f) { fprintf(stderr, "cannot open %s\n", path.c_str()); exit(1); }
  fwrite(d, sizeof(double), n, f);
  fclose(f);
  meta_entry(name, "float64", {n});
}

// serialize via the reference's send(): frame bytes land in
// message_TxRx_byte_buffer, passband in ready_to_transmit_passband_data_tx
static void send_and_dump(cl_arq_controller &arq, st_message &msg,
                          const std::string &name, bool with_passband = false) {
  arq.send(&msg, NO_FILTER_MESSAGE);
  int hdr = 0;
  switch ((unsigned char)msg.type) {
    case DATA_LONG: hdr = DATA_LONG_HEADER_LENGTH; break;
    case DATA_SHORT: hdr = DATA_SHORT_HEADER_LENGTH; break;
    case ACK_RANGE: case ACK_MULTI: hdr = ACK_MULTI_ACK_RANGE_HEADER_LENGTH; break;
    default: hdr = CONTROL_ACK_CONTROL_HEADER_LENGTH; break;
  }
  dump_u8(name + "_bytes",
          (const unsigned char *)arq.message_TxRx_byte_buffer,
          hdr + msg.length);
  if (with_passband) {
    cl_telecom_system &ts = *arq.telecom_system;
    long n = (long)ts.data_container.Nofdm * ts.data_container.interpolation_rate *
             (ts.get_active_nsymb() + ts.data_container.preamble_nSymb);
    dump_f64(name + "_passband",
             ts.data_container.ready_to_transmit_passband_data_tx, n);
  }
  fprintf(stderr, "%s: type=0x%02x len=%d\n", name.c_str(),
          (unsigned char)msg.type, hdr + msg.length);
}

static st_message make_msg(char type, char id, char seq,
                           const std::vector<unsigned char> &payload,
                           char *data_buf) {
  st_message m;
  memset(&m, 0, sizeof(m));
  m.type = type;
  m.id = id;
  m.sequence_number = seq;
  m.length = (int)payload.size();
  m.data = data_buf;
  for (size_t i = 0; i < payload.size(); i++) data_buf[i] = (char)payload[i];
  return m;
}

int main(int argc, char **argv) {
  if (argc < 2) { fprintf(stderr, "usage: link_gen <outdir>\n"); return 1; }
  g_outdir = argv[1];
  g_meta = fopen((g_outdir + "/meta_link.json").c_str(), "w");
  fprintf(g_meta, "{\n");

  // real heap ring buffers so send()'s playback-drain loop sees size 0
  static uint8_t cap_mem[1 << 16], play_mem[1 << 16];
  capture_buffer = circular_buf_init(cap_mem, sizeof(cap_mem));
  playback_buffer = circular_buf_init(play_mem, sizeof(play_mem));

  static cl_telecom_system ts;
  ts.operation_mode = ARQ_MODE;

  static cl_arq_controller arq;
  arq.telecom_system = &ts;
  // the reference init() order (arq_common.cc:543-544) without TCP sockets:
  // FULL at the ack config allocates message buffers, PHYS_ONLY switches
  // the PHY to the data config
  arq.ack_configuration = arq.default_configuration_ARQ.ack_configuration;
  arq.current_configuration = CONFIG_NONE;   // init() does this before loading
  arq.load_configuration(arq.ack_configuration, FULL, NO);
  arq.load_configuration(CONFIG_1, PHYSICAL_LAYER_ONLY, YES);
  arq.connection_id = 0x2A;

  int dims[] = {arq.max_data_length, arq.max_header_length,
                arq.max_message_length, arq.connection_id};
  {
    unsigned char d[4];
    for (int i = 0; i < 4; i++) d[i] = (unsigned char)dims[i];
    dump_u8("link_dims", d, 4);
  }

  static char buf[4096];

  // --- control frames, payloads built by the reference's own
  // add_message_control (arq_commander.cc:287-369)
  arq.my_call_sign = "PP5XX";
  arq.destination_call_sign = "PY2ABC";
  arq.link_status = IDLE;
  arq.add_message_control(START_CONNECTION);
  arq.messages_control.sequence_number = 0;
  send_and_dump(arq, arq.messages_control, "link_start_connection", true);
  arq.messages_control.status = FREE;

  arq.measurements.SNR_uplink = 7.25;
  arq.add_message_control(TEST_CONNECTION);
  arq.messages_control.sequence_number = 0;
  send_and_dump(arq, arq.messages_control, "link_test_connection");
  arq.messages_control.status = FREE;

  arq.gear_shift_algorithm = SUCCESS_BASED_LADDER;
  arq.negotiated_configuration = CONFIG_8;
  arq.reverse_configuration = CONFIG_6;
  arq.add_message_control(SET_CONFIG);
  arq.messages_control.sequence_number = 0;
  send_and_dump(arq, arq.messages_control, "link_set_config");
  arq.messages_control.status = FREE;

  struct { const char *name; char code; } singles[] = {
      {"link_block_end", BLOCK_END},
      {"link_keep_alive", KEEP_ALIVE},
      {"link_close_connection", CLOSE_CONNECTION},
      {"link_switch_role", SWITCH_ROLE},
      {"link_repeat_last_ack", REPEAT_LAST_ACK},
      {"link_file_end", FILE_END_},
  };
  for (auto &s : singles) {
    arq.add_message_control(s.code);
    arq.messages_control.sequence_number = 0;
    send_and_dump(arq, arq.messages_control, s.name);
    arq.messages_control.status = FREE;
  }

  // --- data frames (serialization layout arq_common.cc:2030-2047), in a
  // connected session (START_CONNECTION above reset connection_id to
  // BROADCAST_ID, the pre-connection value)
  arq.connection_id = 0x2A;
  {
    std::vector<unsigned char> payload(arq.max_data_length);
    for (size_t i = 0; i < payload.size(); i++)
      payload[i] = (unsigned char)(i * 7 + 1);
    st_message m = make_msg(DATA_LONG, /*id=*/3, /*seq=*/2, payload, buf);
    send_and_dump(arq, m, "link_data_long", true);
  }
  {
    std::vector<unsigned char> payload(11);
    for (size_t i = 0; i < payload.size(); i++)
      payload[i] = (unsigned char)(0xA0 + i);
    st_message m = make_msg(DATA_SHORT, /*id=*/4, /*seq=*/0, payload, buf);
    send_and_dump(arq, m, "link_data_short");
  }

  // --- stock gearshift-DOWN SET_CONFIG (success-rate downshift /
  // post-BREAK ladder drop emit the same 3-byte layout with lower ids,
  // arq_commander.cc:1059-1129) and a ROBUST-forward instance (the BREAK
  // coordination phase negotiates at ROBUST_0, arq_commander.cc:42-187)
  arq.negotiated_configuration = CONFIG_3;
  arq.reverse_configuration = CONFIG_2;
  arq.add_message_control(SET_CONFIG);
  arq.messages_control.sequence_number = 0;
  send_and_dump(arq, arq.messages_control, "link_set_config_down");
  arq.messages_control.status = FREE;

  arq.negotiated_configuration = ROBUST_0;
  arq.reverse_configuration = ROBUST_0;
  arq.add_message_control(SET_CONFIG);
  arq.messages_control.sequence_number = 0;
  send_and_dump(arq, arq.messages_control, "link_set_config_robust");
  arq.messages_control.status = FREE;

  // --- stock ACK / BREAK tone patterns (the pattern-signaling channel a
  // stock peer uses for connection/data acks and emergency BREAK,
  // telecom_system.cc:1589-1709): generated by the REFERENCE's own
  // generators at the ack config (CONFIG_0, datalink_config.cc), so the
  // repo's PatternSignaler can prove it detects stock tones
  {
    ts.load_configuration(CONFIG_0);
    static double pat[1 << 20];
    int n = ts.generate_ack_pattern_passband(pat);
    dump_f64("link_ack_pattern_passband", pat, n);
    n = ts.generate_break_pattern_passband(pat);
    dump_f64("link_break_pattern_passband", pat, n);
    ts.load_configuration(CONFIG_1);
  }

  // --- responder ACK_MULTI, payload layout arq_responder.cc:523-547:
  // data[0] = nAck, data[1..] = received message ids
  {
    std::vector<unsigned char> payload = {3, 0, 2, 5};
    st_message m = make_msg(ACK_MULTI, 0, 0, payload, buf);
    send_and_dump(arq, m, "link_ack_multi");
  }
  // --- responder ACK_CONTROL (arq_responder.cc:223: echoes the received
  // control's first byte, length 1)
  {
    std::vector<unsigned char> payload = {(unsigned char)TEST_CONNECTION};
    st_message m = make_msg(ACK_CONTROL, 0, 0, payload, buf);
    send_and_dump(arq, m, "link_ack_control");
  }

  fprintf(g_meta, "\n}\n");
  fclose(g_meta);
  fprintf(stderr, "link golden vectors written to %s\n", g_outdir.c_str());
  return 0;
}
