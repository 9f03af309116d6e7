// Copy of toolbox_for_asr_and_tts_tpu/native/funasr_ws_server.cpp for the
// PyTorch/CUDA port, with one change: a NULL from the recognize or the
// partial callback means the model failed, and the connection is closed
// with code 1011 (no empty is_final frame).
//
// funasr_ws_server.cpp — native WebSocket ASR server (FunASR wire protocol).
//
// TPU-era replacement for the reference's FunASR C++ ONNX runtime server
// (`funasr-wss-server` on :10095, spawned by voice-service/start.py:64-113;
// protocol documented in the reference's commented client,
// voice-service/app/services/voice_interface.py:255-296):
//
//   client → {"mode":"offline","wav_name":...,"is_speaking":true,
//             "hotwords":"{...}","chunk_size":[5,10,5],...}   (text frame)
//   client → binary PCM s16le 16 kHz chunks (8 KB each)
//   client → {"is_speaking": false}                            (text frame)
//   server → {"mode":"offline","text":"...","wav_name":...,"is_final":true}
//
// The model math does NOT live here: recognition is delegated through a C
// callback the host process registers (the Python engine binds it via
// ctypes — native/bridge.py). This file owns sockets, the RFC6455
// handshake/framing, per-connection sessions and PCM accumulation —
// the parts the reference kept native.
//
// No third-party deps: inline SHA-1 + base64, hand-rolled frame codec,
// thread-per-connection (the reference server served one service process).
//
// Build: native/bridge.py::build_library (native/Makefile, g++ -O2
// -shared -fPIC -pthread) into the package's _native_build/.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

// ---------------------------------------------------------------- C API
extern "C" {
// Recognize PCM float32 mono 16 kHz; returns malloc'd UTF-8 text the server
// frees with `free_result`. hotwords_json may be empty.
// NULL means the model failed: the server closes the connection with 1011.
typedef char* (*recognize_cb)(const float* samples, int n_samples,
                              const char* hotwords_json);
// Incremental recognition for mode "online"/"2pass": called per audio chunk
// with a per-connection session id; reset=1 flushes/clears the session
// state (utterance end). Returns the current partial hypothesis (malloc'd;
// "" when there is none yet), or NULL when the model failed.
typedef char* (*partial_cb)(unsigned long long session_id,
                            const float* samples, int n_samples, int reset);
typedef void (*free_cb)(char*);

int ws_server_start(int port, recognize_cb cb, free_cb free_fn);
int ws_server_start2(int port, recognize_cb cb, partial_cb pcb,
                     free_cb free_fn);
void ws_server_stop();
int ws_server_port();  // resolved port (for port=0)
}

namespace {

std::atomic<bool> g_running{false};
std::atomic<int> g_listen_fd{-1};
std::atomic<int> g_port{-1};
std::atomic<unsigned long long> g_next_session{1};
recognize_cb g_recognize = nullptr;
partial_cb g_partial = nullptr;
free_cb g_free = nullptr;
std::thread g_accept_thread;

// live connection tracking: ws_server_stop() must not return while any
// detached handler thread could still invoke the Python-owned callbacks
// (use-after-free once the host drops its ctypes trampolines)
std::mutex g_conn_mu;
std::set<int> g_conn_fds;
std::atomic<int> g_conn_count{0};

// registration happens in accept_loop BEFORE the thread is spawned, so
// ws_server_stop can never observe a handler that exists but is not yet
// counted; ConnGuard only ever releases.
void register_conn(int fd) {
  g_conn_count.fetch_add(1);
  std::lock_guard<std::mutex> lk(g_conn_mu);
  g_conn_fds.insert(fd);
}

struct ConnGuard {
  int fd;
  explicit ConnGuard(int f) : fd(f) {}
  ~ConnGuard() {
    {
      std::lock_guard<std::mutex> lk(g_conn_mu);
      g_conn_fds.erase(fd);
    }
    g_conn_count.fetch_sub(1);
  }
};

// ------------------------------------------------------------- SHA-1
struct Sha1 {
  uint32_t h[5] = {0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0};
  static uint32_t rol(uint32_t v, int b) { return (v << b) | (v >> (32 - b)); }
  void block(const uint8_t* p) {
    uint32_t w[80];
    for (int i = 0; i < 16; i++)
      w[i] = (p[4 * i] << 24) | (p[4 * i + 1] << 16) | (p[4 * i + 2] << 8) |
             p[4 * i + 3];
    for (int i = 16; i < 80; i++)
      w[i] = rol(w[i - 3] ^ w[i - 8] ^ w[i - 14] ^ w[i - 16], 1);
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4];
    for (int i = 0; i < 80; i++) {
      uint32_t f, k;
      if (i < 20) { f = (b & c) | ((~b) & d); k = 0x5A827999; }
      else if (i < 40) { f = b ^ c ^ d; k = 0x6ED9EBA1; }
      else if (i < 60) { f = (b & c) | (b & d) | (c & d); k = 0x8F1BBCDC; }
      else { f = b ^ c ^ d; k = 0xCA62C1D6; }
      uint32_t t = rol(a, 5) + f + e + k + w[i];
      e = d; d = c; c = rol(b, 30); b = a; a = t;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d; h[4] += e;
  }
  void digest(const std::string& msg, uint8_t out[20]) {
    std::vector<uint8_t> data(msg.begin(), msg.end());
    uint64_t bits = data.size() * 8ULL;
    data.push_back(0x80);
    while (data.size() % 64 != 56) data.push_back(0);
    for (int i = 7; i >= 0; i--) data.push_back((bits >> (8 * i)) & 0xFF);
    for (size_t i = 0; i < data.size(); i += 64) block(&data[i]);
    for (int i = 0; i < 5; i++) {
      out[4 * i] = (h[i] >> 24) & 0xFF; out[4 * i + 1] = (h[i] >> 16) & 0xFF;
      out[4 * i + 2] = (h[i] >> 8) & 0xFF; out[4 * i + 3] = h[i] & 0xFF;
    }
  }
};

std::string base64(const uint8_t* data, size_t n) {
  static const char* tbl =
      "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
  std::string out;
  for (size_t i = 0; i < n; i += 3) {
    uint32_t v = data[i] << 16;
    if (i + 1 < n) v |= data[i + 1] << 8;
    if (i + 2 < n) v |= data[i + 2];
    out += tbl[(v >> 18) & 63];
    out += tbl[(v >> 12) & 63];
    out += (i + 1 < n) ? tbl[(v >> 6) & 63] : '=';
    out += (i + 2 < n) ? tbl[v & 63] : '=';
  }
  return out;
}

// -------------------------------------------------- tiny JSON field reads
// The init message is flat JSON; extract without a parser dependency.
std::string json_string_field(const std::string& s, const std::string& key) {
  std::string pat = "\"" + key + "\"";
  size_t p = s.find(pat);
  if (p == std::string::npos) return "";
  p = s.find(':', p + pat.size());
  if (p == std::string::npos) return "";
  p++;
  while (p < s.size() && (s[p] == ' ' || s[p] == '\t')) p++;
  if (p >= s.size() || s[p] != '"') return "";
  std::string out;
  for (size_t i = p + 1; i < s.size(); i++) {
    if (s[i] == '\\' && i + 1 < s.size()) {
      char n = s[i + 1];
      if (n == '"' || n == '\\' || n == '/') { out += n; i++; }
      else { out += '\\'; out += n; i++; }  // keep \uXXXX etc. intact
      continue;
    }
    if (s[i] == '"') break;
    out += s[i];
  }
  return out;
}

bool json_bool_field(const std::string& s, const std::string& key, bool dflt) {
  std::string pat = "\"" + key + "\"";
  size_t p = s.find(pat);
  if (p == std::string::npos) return dflt;
  p = s.find(':', p + pat.size());
  if (p == std::string::npos) return dflt;
  size_t t = s.find("true", p), f = s.find("false", p);
  if (t != std::string::npos && (f == std::string::npos || t < f) && t < p + 8)
    return true;
  if (f != std::string::npos && f < p + 8) return false;
  return dflt;
}

std::string json_escape(const std::string& s) {
  std::string out;
  for (char c : s) {
    if (c == '"' || c == '\\') { out += '\\'; out += c; }
    else if (c == '\n') out += "\\n";
    else if ((unsigned char)c >= 0x20 || (unsigned char)c >= 0x80) out += c;
  }
  return out;
}

// ------------------------------------------------------------ socket io
bool read_exact(int fd, uint8_t* buf, size_t n) {
  size_t got = 0;
  while (got < n) {
    ssize_t r = recv(fd, buf + got, n - got, 0);
    if (r <= 0) return false;
    got += r;
  }
  return true;
}

bool write_all(int fd, const uint8_t* buf, size_t n) {
  size_t sent = 0;
  while (sent < n) {
    ssize_t r = send(fd, buf + sent, n - sent, MSG_NOSIGNAL);
    if (r <= 0) return false;
    sent += r;
  }
  return true;
}

bool ws_send(int fd, uint8_t opcode, const std::string& payload) {
  std::vector<uint8_t> hdr;
  hdr.push_back(0x80 | opcode);
  size_t n = payload.size();
  if (n < 126) hdr.push_back((uint8_t)n);
  else if (n < 65536) {
    hdr.push_back(126);
    hdr.push_back((n >> 8) & 0xFF); hdr.push_back(n & 0xFF);
  } else {
    hdr.push_back(127);
    for (int i = 7; i >= 0; i--) hdr.push_back((n >> (8 * i)) & 0xFF);
  }
  if (!write_all(fd, hdr.data(), hdr.size())) return false;
  return write_all(fd, (const uint8_t*)payload.data(), n);
}

// one complete message (handles continuation, unmasking, ping/pong/close)
bool ws_recv(int fd, uint8_t* opcode_out, std::string* payload_out) {
  std::string message;
  uint8_t msg_opcode = 0;
  while (true) {
    uint8_t hdr[2];
    if (!read_exact(fd, hdr, 2)) return false;
    bool fin = hdr[0] & 0x80;
    uint8_t opcode = hdr[0] & 0x0F;
    bool masked = hdr[1] & 0x80;
    uint64_t len = hdr[1] & 0x7F;
    if (len == 126) {
      uint8_t ext[2];
      if (!read_exact(fd, ext, 2)) return false;
      len = (ext[0] << 8) | ext[1];
    } else if (len == 127) {
      uint8_t ext[8];
      if (!read_exact(fd, ext, 8)) return false;
      len = 0;
      for (int i = 0; i < 8; i++) len = (len << 8) | ext[i];
    }
    if (len > (64ULL << 20)) return false;
    uint8_t mask[4] = {0, 0, 0, 0};
    if (masked && !read_exact(fd, mask, 4)) return false;
    std::string payload(len, '\0');
    if (len && !read_exact(fd, (uint8_t*)payload.data(), len)) return false;
    if (masked)
      for (uint64_t i = 0; i < len; i++) payload[i] ^= mask[i & 3];
    if (opcode == 0x8) return false;                 // close
    if (opcode == 0x9) { ws_send(fd, 0xA, payload); continue; }  // ping
    if (opcode == 0xA) continue;                     // pong
    if (opcode == 0x1 || opcode == 0x2) msg_opcode = opcode;
    // cap the TOTAL message across continuation fragments too, not just each
    // frame — unbounded accumulation is a memory-exhaustion DoS
    if (message.size() + payload.size() > (64ULL << 20)) return false;
    message += payload;
    if (fin && msg_opcode) {
      *opcode_out = msg_opcode;
      *payload_out = std::move(message);
      return true;
    }
  }
}

// A model callback returned NULL: close with 1011 (internal error), so a
// failure never reaches the client as an empty final.
void close_model_error(int fd) {
  static const char kPayload[] = "\x03\xf3" "model error";  // code 1011
  ws_send(fd, 0x8, std::string(kPayload, sizeof(kPayload) - 1));
}

// -------------------------------------------------------------- session
void handle_connection(int fd) {
  ConnGuard guard(fd);   // stop() drains these before returning
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // HTTP upgrade
  std::string req;
  char c;
  while (req.find("\r\n\r\n") == std::string::npos) {
    if (recv(fd, &c, 1, 0) <= 0) { close(fd); return; }
    req += c;
    if (req.size() > 65536) { close(fd); return; }
  }
  size_t kp = req.find("Sec-WebSocket-Key:");
  if (kp == std::string::npos) { close(fd); return; }
  kp += strlen("Sec-WebSocket-Key:");
  while (kp < req.size() && req[kp] == ' ') kp++;
  size_t ke = req.find("\r\n", kp);
  std::string key = req.substr(kp, ke - kp);
  uint8_t digest[20];
  Sha1().digest(key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11", digest);
  std::string resp =
      "HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
      "Connection: Upgrade\r\nSec-WebSocket-Accept: " +
      base64(digest, 20) + "\r\n\r\n";
  if (!write_all(fd, (const uint8_t*)resp.data(), resp.size())) {
    close(fd);
    return;
  }

  // FunASR session: accumulate PCM until {"is_speaking": false}.
  // mode "offline": single final result. mode "online": streaming partials
  // only. mode "2pass": partials per chunk + offline-quality final.
  std::string wav_name = "default", hotwords, mode = "offline";
  std::vector<float> pcm;
  unsigned long long session_id = g_next_session.fetch_add(1);
  uint8_t opcode;
  std::string payload;
  auto send_result = [&](const std::string& m, const std::string& text,
                         bool is_final) {
    std::string out = "{\"mode\":\"" + json_escape(m) +
                      "\",\"wav_name\":\"" + json_escape(wav_name) +
                      "\",\"text\":\"" + json_escape(text) +
                      std::string("\",\"is_final\":") +
                      (is_final ? "true}" : "false}");
    ws_send(fd, 0x1, out);
  };
  bool model_failed = false;
  while (!model_failed && g_running && ws_recv(fd, &opcode, &payload)) {
    bool streaming_mode = (mode == "online" || mode == "2pass");
    if (opcode == 0x1) {  // text: init / control
      std::string wn = json_string_field(payload, "wav_name");
      if (!wn.empty()) wav_name = wn;
      std::string hw = json_string_field(payload, "hotwords");
      if (!hw.empty()) hotwords = hw;
      std::string md = json_string_field(payload, "mode");
      if (!md.empty()) mode = md;
      bool speaking = json_bool_field(payload, "is_speaking", true);
      if (!speaking) {
        // a server started without a partial callback answers "online"
        // clients through the offline path too — EVERY end-of-utterance
        // marker must produce an is_final frame
        if (mode != "online" || !g_partial) {
          // ALWAYS answer the end-of-utterance marker — an empty buffer
          // (no audio sent, or the runaway guard cleared it) must still
          // produce the is_final frame or FunASR clients block forever
          std::string text;
          if (g_recognize && !pcm.empty()) {
            char* r =
                g_recognize(pcm.data(), (int)pcm.size(), hotwords.c_str());
            if (!r) {
              model_failed = true;
              break;
            }
            text = r;
            if (g_free) g_free(r);
          }
          send_result(mode == "2pass" ? "2pass-offline" : mode, text, true);
        }
        if (streaming_mode && g_partial) {  // flush + reset streaming state
          char* r = g_partial(session_id, nullptr, 0, 1);
          if (!r) {
            model_failed = true;
            break;
          }
          if (mode == "online") send_result("online", r, true);
          if (g_free) g_free(r);
        }
        pcm.clear();  // session may continue with a new utterance
      }
    } else if (opcode == 0x2) {  // binary: PCM s16le chunks
      size_t n = payload.size() / 2;
      size_t old = pcm.size();
      pcm.resize(old + n);
      const int16_t* s = (const int16_t*)payload.data();
      for (size_t i = 0; i < n; i++) pcm[old + i] = s[i] / 32768.0f;
      if (streaming_mode && g_partial && n > 0) {
        char* r = g_partial(session_id, pcm.data() + old, (int)n, 0);
        if (!r) {
          model_failed = true;
          break;
        }
        if (r[0] != '\0')
          send_result(mode == "2pass" ? "2pass-online" : "online", r, false);
        if (g_free) g_free(r);
      }
      if (pcm.size() > 16000ULL * 600) pcm.clear();  // runaway guard
    }
  }
  if (model_failed) close_model_error(fd);
  if (g_partial) {  // connection gone: drop any streaming state
    char* r = g_partial(session_id, nullptr, 0, 1);
    if (r && g_free) g_free(r);
  }
  close(fd);
}

void accept_loop() {
  while (g_running) {
    sockaddr_in addr;
    socklen_t alen = sizeof(addr);
    int fd = accept(g_listen_fd, (sockaddr*)&addr, &alen);
    if (fd < 0) {
      if (!g_running) break;
      continue;
    }
    register_conn(fd);
    std::thread(handle_connection, fd).detach();
  }
}

}  // namespace

extern "C" {

int ws_server_start(int port, recognize_cb cb, free_cb free_fn) {
  return ws_server_start2(port, cb, nullptr, free_fn);
}

int ws_server_start2(int port, recognize_cb cb, partial_cb pcb,
                     free_cb free_fn) {
  if (g_running) return -1;
  g_recognize = cb;
  g_partial = pcb;
  g_free = free_fn;
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -2;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(port);
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) < 0) { close(fd); return -3; }
  if (listen(fd, 64) < 0) { close(fd); return -4; }
  socklen_t alen = sizeof(addr);
  getsockname(fd, (sockaddr*)&addr, &alen);
  g_port = ntohs(addr.sin_port);
  g_listen_fd = fd;
  g_running = true;
  g_accept_thread = std::thread(accept_loop);
  return 0;
}

void ws_server_stop() {
  g_running = false;
  int fd = g_listen_fd.exchange(-1);
  if (fd >= 0) {
    shutdown(fd, SHUT_RDWR);
    close(fd);
  }
  if (g_accept_thread.joinable()) g_accept_thread.join();
  // unblock detached handler threads stuck in recv() and wait for them to
  // finish: after stop() returns, the host may free the callback
  // trampolines, so no handler may still be running
  {
    std::lock_guard<std::mutex> lk(g_conn_mu);
    for (int cfd : g_conn_fds) shutdown(cfd, SHUT_RDWR);
  }
  // generous: a handler may be inside a long recognition callback (minutes
  // of audio over a slow link); abandoning it would let the host free the
  // ctypes trampolines under a live C++ caller
  auto deadline = std::chrono::steady_clock::now() + std::chrono::seconds(120);
  while (g_conn_count.load() > 0 &&
         std::chrono::steady_clock::now() < deadline) {
    std::this_thread::sleep_for(std::chrono::milliseconds(5));
  }
}

int ws_server_port() { return g_port; }

}  // extern "C"
