// Copy of toolbox_for_asr_and_tts_tpu/native/wsload_client.cpp for the
// PyTorch/CUDA port; it drives the port's voice app the same way.
//
// wsload_client.cpp — epoll WebSocket load generator for the voice service.
//
// Why native: `benchmarks/run.py wsload` measures BASELINE config #5
// (concurrent client load through the WS service stack), but on a 1-CPU
// host N Python client threads contend with the server process for the
// same core — past 64 streams the CLIENT is what fails (thread rendezvous
// never completes; see benchmarks/RESULTS.md round-3 ceiling probes). This
// program drives all N streams from ONE thread on an epoll loop, sending
// binary s16le PCM chunks (the FunASR-protocol chunk format the service
// accepts, service/voice_app.py binary-frame path) with a zero mask key
// (RFC6455-legal; XOR with 0 is the identity, so the client never touches
// the payload bytes), leaving the core to the system under test.
//
// Reference counterpart: none — the reference ships no load harness at all
// (SURVEY §4: no test suite). This is benchmark infrastructure the TPU
// build adds.
//
// Protocol (mirrors benchmarks/run.py's Python client):
//   connect → HTTP 101 upgrade → recv welcome (text JSON)
//   → send {"use_wake":false,"use_sv":false,"use_llm":false} (text)
//   → rendezvous: wait until ALL streams are open, then stagger starts
//   → per cycle: S speech + Q silence chunks at --chunk-ms pace (binary),
//     draining result frames continuously; a cycle passes when a frame
//     containing "type": "result" arrives ≤ --deadline s after the most
//     recent chunk send. Cycle 0 is an uncounted grace cycle (first-compile
//     shapes), like every bench in benchmarks/run.py.
//
// --wake enables the reference's full 4-mode FSM (voice.py:375-663, the
// VOICE_REQUIRE_WAKE medical deployment shape) before the ASR cycles,
// mirroring benchmarks/run.py::wake_client:
//   flags {"use_wake":true,"use_sv":true} → W wake speech chunks → await
//   {"type":"wakeup"} → E speech + silence chunks until
//   {"type":"enrollment_completed"} → {"type":"start_asr"} → await
//   "asr_started" → SV-gated ASR cycles as above. Wake/enroll latencies
//   (from the most recent chunk send, same convention) are reported per
//   stream as "wake":[...] and "enroll":[...].
//
// Output: one JSON line per stream on stdout:
//   {"idx":3,"ok":true,"lat":[0.41,0.38]}   (lat = non-grace result lats, s)
// then a summary line {"summary":{"n":..,"ok":..}}.
//
// Build: native/bridge.py::build_library (native/Makefile) into the
// package's _native_build/; `python -m
// toolbox_for_asr_and_tts_tpu_torch.native.bridge` prints its path.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

double mono_now() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + ts.tv_nsec * 1e-9;
}

// ------------------------------------------------------------ WS framing
// Client→server frame with a ZERO mask key: header + raw payload.
void append_frame(std::vector<uint8_t>& out, uint8_t opcode,
                  const uint8_t* payload, size_t n) {
    out.push_back(0x80 | opcode);                  // FIN + opcode
    if (n < 126) {
        out.push_back(0x80 | (uint8_t)n);          // MASK bit + len
    } else if (n < 65536) {
        out.push_back(0x80 | 126);
        out.push_back((uint8_t)(n >> 8));
        out.push_back((uint8_t)(n & 0xff));
    } else {
        out.push_back(0x80 | 127);
        for (int i = 7; i >= 0; --i)
            out.push_back((uint8_t)((uint64_t)n >> (8 * i)));
    }
    out.insert(out.end(), {0, 0, 0, 0});           // zero mask key
    out.insert(out.end(), payload, payload + n);
}

struct Conn {
    int fd = -1;
    int idx = 0;
    // ---- lifecycle
    enum Phase { CONNECTING, HTTP, WELCOME, BARRIER, RUNNING, DONE, FAILED };
    Phase phase = CONNECTING;
    std::string fail_reason;
    // ---- buffers
    std::string rx;                 // raw inbound bytes (frames + HTTP)
    std::vector<uint8_t> tx;        // outbound backlog
    size_t tx_off = 0;
    // ---- load loop
    int cycle = 0;
    int chunk_i = 0;                // next pattern position to send
    double next_send = 0;           // monotonic deadline of next chunk
    double t_send = 0;              // most recent chunk send (lat origin)
    bool got_result = false;
    bool missed = false;            // this cycle blew the deadline
    bool warned = false;
    std::vector<double> lat;        // non-grace result latencies
    // ---- wake FSM (--wake only; plain mode starts directly at W_ASR)
    enum WakeStage { W_WAKE, W_WAKE_WAIT, W_ENROLL_SP, W_ENROLL_SIL,
                     W_ENROLL_WAIT, W_CONFIRM, W_ASR };
    WakeStage stage = W_ASR;
    bool seen_wakeup = false, seen_enrolled = false, seen_started = false;
    std::vector<double> wake_lat, enroll_lat;
};

struct Args {
    std::string host = "127.0.0.1";
    int port = 0;
    std::string path = "/api/v1/voice/asr/ws";
    int n = 8;
    int cycles = 3;
    double deadline = 4.0;
    double chunk_s = 0.4;
    double stagger_s = 0.05;
    int stagger_mod = 8;
    std::string speech_file, silence_file;
    int speech_chunks = 3, silence_chunks = 7;
    double hard_timeout = 60.0;     // absolute per-cycle result wait cap
    double connect_timeout = 30.0;
    // ---- wake mode (mirrors benchmarks/run.py WAKE_N_* constants)
    bool wake = false;
    int wake_chunks = 4;            // 1600 ms KWS FIFO at 400 ms chunks
    int enroll_speech = 8, enroll_silence = 8;
    double wake_timeout = 600.0;    // wake/enroll/confirm phase wait cap
};

std::vector<uint8_t> read_file(const std::string& p) {
    std::vector<uint8_t> v;
    FILE* f = fopen(p.c_str(), "rb");
    if (!f) { perror(p.c_str()); exit(2); }
    uint8_t buf[65536];
    size_t k;
    while ((k = fread(buf, 1, sizeof buf, f)) > 0)
        v.insert(v.end(), buf, buf + k);
    fclose(f);
    return v;
}

bool flush_tx(Conn& c) {
    while (c.tx_off < c.tx.size()) {
        ssize_t k = send(c.fd, c.tx.data() + c.tx_off,
                         c.tx.size() - c.tx_off, MSG_NOSIGNAL);
        if (k > 0) { c.tx_off += (size_t)k; continue; }
        if (k < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return true;
        return false;
    }
    c.tx.clear();
    c.tx_off = 0;
    return true;
}

}  // namespace

int main(int argc, char** argv) {
    Args a;
    for (int i = 1; i < argc; ++i) {
        std::string k = argv[i];
        auto next = [&]() -> std::string {
            if (i + 1 >= argc) { fprintf(stderr, "missing value for %s\n",
                                         k.c_str()); exit(2); }
            return argv[++i];
        };
        if (k == "--host") a.host = next();
        else if (k == "--port") a.port = atoi(next().c_str());
        else if (k == "--path") a.path = next();
        else if (k == "--n") a.n = atoi(next().c_str());
        else if (k == "--cycles") a.cycles = atoi(next().c_str());
        else if (k == "--deadline") a.deadline = atof(next().c_str());
        else if (k == "--chunk-ms") a.chunk_s = atof(next().c_str()) / 1e3;
        else if (k == "--stagger-ms") a.stagger_s = atof(next().c_str()) / 1e3;
        else if (k == "--stagger-mod") a.stagger_mod = atoi(next().c_str());
        else if (k == "--speech") a.speech_file = next();
        else if (k == "--silence") a.silence_file = next();
        else if (k == "--speech-chunks") a.speech_chunks = atoi(next().c_str());
        else if (k == "--silence-chunks")
            a.silence_chunks = atoi(next().c_str());
        else if (k == "--hard-timeout") a.hard_timeout = atof(next().c_str());
        else if (k == "--connect-timeout")
            a.connect_timeout = atof(next().c_str());
        else if (k == "--wake") a.wake = true;
        else if (k == "--wake-chunks") a.wake_chunks = atoi(next().c_str());
        else if (k == "--enroll-speech")
            a.enroll_speech = atoi(next().c_str());
        else if (k == "--enroll-silence")
            a.enroll_silence = atoi(next().c_str());
        else if (k == "--wake-timeout") a.wake_timeout = atof(next().c_str());
        else { fprintf(stderr, "unknown arg %s\n", k.c_str()); return 2; }
    }
    if (!a.port || a.speech_file.empty() || a.silence_file.empty()) {
        fprintf(stderr, "usage: wsload_client --port P --speech F --silence F"
                        " [--n N --cycles C --deadline S ...]\n");
        return 2;
    }
    std::vector<uint8_t> speech = read_file(a.speech_file);
    std::vector<uint8_t> silence = read_file(a.silence_file);
    const int pattern_len = a.speech_chunks + a.silence_chunks;
    const double hard_cap = a.hard_timeout > a.deadline ? a.hard_timeout
                                                        : a.deadline;

    std::string upgrade_tail =
        "GET " + a.path + " HTTP/1.1\r\n"
        "Host: " + a.host + "\r\n"
        "Upgrade: websocket\r\nConnection: Upgrade\r\n"
        "Sec-WebSocket-Key: d3Nsb2FkX2NsaWVudF9rZXk=\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n";
    std::string flags_json = a.wake
        ? "{\"use_wake\": true, \"use_sv\": true, \"use_llm\": false}"
        : "{\"use_wake\": false, \"use_sv\": false, \"use_llm\": false}";

    int ep = epoll_create1(0);
    if (ep < 0) { perror("epoll_create1"); return 2; }
    std::vector<Conn> conns(a.n);

    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)a.port);
    if (inet_pton(AF_INET, a.host.c_str(), &addr.sin_addr) != 1) {
        fprintf(stderr, "bad host %s\n", a.host.c_str());
        return 2;
    }

    auto arm = [&](Conn& c, bool want_write) {
        epoll_event ev{};
        ev.events = EPOLLIN | (want_write ? (uint32_t)EPOLLOUT : 0u);
        ev.data.u32 = (uint32_t)c.idx;
        epoll_ctl(ep, EPOLL_CTL_MOD, c.fd, &ev);
    };
    auto fail = [&](Conn& c, const std::string& why) {
        if (c.phase != Conn::FAILED && c.phase != Conn::DONE) {
            c.phase = Conn::FAILED;
            c.fail_reason = why;
            fprintf(stderr, "stream %d failed: %s\n", c.idx, why.c_str());
        }
        if (c.fd >= 0) { epoll_ctl(ep, EPOLL_CTL_DEL, c.fd, nullptr);
                         close(c.fd); c.fd = -1; }
    };
    auto queue_bytes = [&](Conn& c, const uint8_t* p, size_t n) {
        c.tx.insert(c.tx.end(), p, p + n);
        if (!flush_tx(c)) fail(c, "send error");
        else arm(c, !c.tx.empty());
    };
    auto queue_frame = [&](Conn& c, uint8_t op, const uint8_t* p, size_t n) {
        std::vector<uint8_t> f;
        append_frame(f, op, p, n);
        queue_bytes(c, f.data(), f.size());
    };

    // ---- connect everything (nonblocking)
    double t0 = mono_now();
    for (int i = 0; i < a.n; ++i) {
        Conn& c = conns[i];
        c.idx = i;
        c.fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
        if (c.fd < 0) { fail(c, "socket()"); continue; }
        int one = 1;
        setsockopt(c.fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
        epoll_event ev{};
        ev.events = EPOLLIN | EPOLLOUT;
        ev.data.u32 = (uint32_t)i;
        epoll_ctl(ep, EPOLL_CTL_ADD, c.fd, &ev);
        if (connect(c.fd, (sockaddr*)&addr, sizeof addr) < 0 &&
            errno != EINPROGRESS)
            fail(c, "connect()");
    }

    bool started = false;            // rendezvous released?
    double start_t = 0;
    int done = 0, failed = 0;

    auto finish = [&](Conn& c, bool ok, const char* why) {
        if (ok) { c.phase = Conn::DONE; ++done; }
        else fail(c, why);
        if (c.fd >= 0 && ok) {
            // polite close; the server reaps the session either way
            uint8_t code[2] = {0x03, 0xe8};
            queue_frame(c, 0x8, code, 2);
        }
    };

    // result detector: the service emits json.dumps(..) text frames —
    // match both spacings defensively
    auto has_kv = [](const std::string& s, const char* key, const char* val) {
        std::string spaced = std::string("\"") + key + "\": \"" + val + "\"";
        std::string tight = std::string("\"") + key + "\":\"" + val + "\"";
        return s.find(spaced) != std::string::npos ||
               s.find(tight) != std::string::npos;
    };
    auto has_result = [&](const std::string& s) {
        return has_kv(s, "type", "result");
    };

    // ---- handle one complete inbound WS frame
    auto on_frame = [&](Conn& c, uint8_t opcode, std::string payload) {
        if (opcode == 0x9) {                       // ping → pong
            queue_frame(c, 0xA, (const uint8_t*)payload.data(),
                        payload.size());
            return;
        }
        if (opcode == 0x8) { fail(c, "server closed"); return; }
        if (opcode != 0x1) return;                 // binary/unknown: ignore
        if (c.phase == Conn::WELCOME) {
            // welcome frame → send flags, join the barrier
            queue_frame(c, 0x1, (const uint8_t*)flags_json.data(),
                        flags_json.size());
            c.phase = Conn::BARRIER;
            return;
        }
        if (c.phase != Conn::RUNNING) return;
        if (a.wake) {
            // wake-FSM milestone frames (latency from most recent chunk
            // send, the Python client's convention)
            if (!c.seen_wakeup && has_kv(payload, "type", "wakeup")) {
                c.seen_wakeup = true;
                c.wake_lat.push_back(mono_now() - c.t_send);
                return;
            }
            if (!c.seen_enrolled &&
                has_kv(payload, "type", "enrollment_completed")) {
                c.seen_enrolled = true;
                c.enroll_lat.push_back(mono_now() - c.t_send);
                return;
            }
            if (!c.seen_started &&
                has_kv(payload, "status", "asr_started")) {
                c.seen_started = true;
                return;
            }
        }
        if (c.stage == Conn::W_ASR && has_result(payload)) {
            c.got_result = true;
            double now = mono_now();
            bool grace = (c.cycle == 0 && a.cycles > 1);
            if (!grace) c.lat.push_back(now - c.t_send);
        }
    };

    // ---- drain c.rx: HTTP response first, then frames
    auto on_readable = [&](Conn& c) {
        char buf[65536];
        for (;;) {
            ssize_t k = recv(c.fd, buf, sizeof buf, 0);
            if (k > 0) { c.rx.append(buf, (size_t)k); continue; }
            if (k == 0) { fail(c, "peer EOF"); return; }
            if (errno == EAGAIN || errno == EWOULDBLOCK) break;
            fail(c, "recv error");
            return;
        }
        if (c.phase == Conn::HTTP) {
            size_t e = c.rx.find("\r\n\r\n");
            if (e == std::string::npos) return;
            std::string head = c.rx.substr(0, e);
            if (head.find(" 101") == std::string::npos) {
                fail(c, "upgrade rejected");
                return;
            }
            c.rx.erase(0, e + 4);
            c.phase = Conn::WELCOME;
        }
        // frame loop (server frames are unmasked)
        while (c.phase != Conn::FAILED && c.rx.size() >= 2) {
            const uint8_t* d = (const uint8_t*)c.rx.data();
            uint8_t opcode = d[0] & 0x0f;
            bool masked = d[1] & 0x80;
            uint64_t len = d[1] & 0x7f;
            size_t off = 2;
            if (len == 126) {
                if (c.rx.size() < 4) return;
                len = ((uint64_t)d[2] << 8) | d[3];
                off = 4;
            } else if (len == 127) {
                if (c.rx.size() < 10) return;
                len = 0;
                for (int i = 0; i < 8; ++i) len = (len << 8) | d[2 + i];
                off = 10;
            }
            size_t mask_off = off;
            if (masked) off += 4;
            if (c.rx.size() < off + len) return;
            std::string payload = c.rx.substr(off, len);
            if (masked)
                for (size_t i = 0; i < payload.size(); ++i)
                    payload[i] ^= c.rx[mask_off + (i & 3)];
            c.rx.erase(0, off + len);
            on_frame(c, opcode, std::move(payload));
        }
    };

    // ---- main loop
    for (;;) {
        int live = 0;
        for (auto& c : conns)
            if (c.phase != Conn::DONE && c.phase != Conn::FAILED) ++live;
        failed = 0;
        for (auto& c : conns) if (c.phase == Conn::FAILED) ++failed;
        if (!live) break;

        double now = mono_now();

        // rendezvous: release once every surviving stream reached BARRIER
        if (!started) {
            int at_barrier = 0;
            for (auto& c : conns)
                if (c.phase == Conn::BARRIER) ++at_barrier;
            if (at_barrier + failed == a.n && at_barrier > 0) {
                started = true;
                start_t = now + 0.2;
                for (auto& c : conns)
                    if (c.phase == Conn::BARRIER) {
                        c.phase = Conn::RUNNING;
                        c.stage = a.wake ? Conn::W_WAKE : Conn::W_ASR;
                        c.next_send = start_t +
                            (c.idx % a.stagger_mod) * a.stagger_s;
                    }
                fprintf(stderr, "wsload_client: %d/%d streams open, "
                        "starting\n", at_barrier, a.n);
            } else if (now - t0 > a.connect_timeout) {
                for (auto& c : conns)
                    if (c.phase != Conn::BARRIER && c.phase != Conn::FAILED)
                        fail(c, "connect/handshake timeout");
                continue;
            }
        }

        // per-conn pacing + cycle bookkeeping
        double wake = now + 0.5;
        for (auto& c : conns) {
            if (c.phase != Conn::RUNNING) continue;
            // ---- wake FSM stages (before the ASR cycle machinery) ------
            if (c.stage != Conn::W_ASR) {
                auto send_chunk = [&](bool sp) {
                    const auto& pcm = sp ? speech : silence;
                    c.t_send = now;
                    queue_frame(c, 0x2, pcm.data(), pcm.size());
                    ++c.chunk_i;
                    c.next_send += a.chunk_s;
                };
                switch (c.stage) {
                case Conn::W_WAKE:       // 4 speech chunks fill the KWS FIFO
                    if (now >= c.next_send) {
                        send_chunk(true);
                        if (c.chunk_i >= a.wake_chunks) {
                            c.stage = Conn::W_WAKE_WAIT;
                            c.chunk_i = 0;
                        }
                    }
                    break;
                case Conn::W_WAKE_WAIT:
                    if (c.seen_wakeup) {
                        c.stage = Conn::W_ENROLL_SP;
                        c.next_send = now;
                    } else if (now - c.t_send > a.wake_timeout) {
                        finish(c, false, "no wakeup");
                        continue;
                    }
                    break;
                case Conn::W_ENROLL_SP:  // enrollment speech
                    if (now >= c.next_send) {
                        send_chunk(true);
                        if (c.chunk_i >= a.enroll_speech) {
                            c.stage = Conn::W_ENROLL_SIL;
                            c.chunk_i = 0;
                        }
                    }
                    break;
                case Conn::W_ENROLL_SIL: // silence until the AND-rule fires
                    if (c.seen_enrolled) {
                        c.stage = Conn::W_CONFIRM;
                        c.t_send = now;
                        queue_frame(c, 0x1,
                                    (const uint8_t*)"{\"type\": \"start_asr\"}",
                                    21);
                        break;
                    }
                    if (now >= c.next_send) {
                        send_chunk(false);
                        if (c.chunk_i >= a.enroll_silence)
                            c.stage = Conn::W_ENROLL_WAIT;
                    }
                    break;
                case Conn::W_ENROLL_WAIT:
                    if (c.seen_enrolled) {
                        c.stage = Conn::W_CONFIRM;
                        c.t_send = now;
                        queue_frame(c, 0x1,
                                    (const uint8_t*)"{\"type\": \"start_asr\"}",
                                    21);
                    } else if (now - c.t_send > a.wake_timeout) {
                        finish(c, false, "no enrollment_completed");
                        continue;
                    }
                    break;
                case Conn::W_CONFIRM:
                    if (c.seen_started) {
                        c.stage = Conn::W_ASR;
                        c.chunk_i = 0;
                        c.got_result = false;
                        c.next_send = now;
                    } else if (now - c.t_send > a.wake_timeout) {
                        finish(c, false, "no asr_started");
                        continue;
                    }
                    break;
                case Conn::W_ASR:
                    break;
                }
                if (c.phase != Conn::RUNNING) continue;
                bool sending = (c.stage == Conn::W_WAKE ||
                                c.stage == Conn::W_ENROLL_SP ||
                                c.stage == Conn::W_ENROLL_SIL);
                double due = sending ? c.next_send : now + 0.05;
                wake = wake < due ? wake : due;
                if (c.stage != Conn::W_ASR) continue;
                // fall through into the ASR cycle machinery this iteration
            }
            if (c.chunk_i < pattern_len) {
                if (now >= c.next_send) {
                    const bool sp = c.chunk_i < a.speech_chunks;
                    const auto& pcm = sp ? speech : silence;
                    c.t_send = now;
                    queue_frame(c, 0x2, pcm.data(), pcm.size());
                    ++c.chunk_i;
                    c.next_send += a.chunk_s;
                }
                if (c.phase == Conn::RUNNING)
                    wake = wake < c.next_send ? wake : c.next_send;
                continue;
            }
            // pattern exhausted: wait for the cycle's result
            bool grace = (c.cycle == 0 && a.cycles > 1);
            double waited = now - c.t_send;
            if (!c.got_result) {
                if (waited > a.deadline) c.missed = true;
                if (c.missed && !c.warned && waited > 15.0) {
                    c.warned = true;
                    fprintf(stderr, "stream %d cycle %d: result >15s late\n",
                            c.idx, c.cycle);
                }
                if (waited > hard_cap) {
                    finish(c, false, "result wait exceeded hard cap");
                    continue;
                }
                wake = wake < now + 0.05 ? wake : now + 0.05;
                continue;
            }
            if (c.missed && !grace) {
                finish(c, false, "missed deadline");
                continue;
            }
            // next cycle
            ++c.cycle;
            if (c.cycle >= a.cycles) {
                finish(c, true, nullptr);
                continue;
            }
            c.chunk_i = 0;
            c.got_result = false;
            c.missed = false;
            c.warned = false;
            c.next_send = now;  // keep real-time pace from this instant
        }

        now = mono_now();
        int timeout_ms = (int)((wake - now) * 1000);
        if (timeout_ms < 0) timeout_ms = 0;
        if (timeout_ms > 500) timeout_ms = 500;
        epoll_event evs[256];
        int k = epoll_wait(ep, evs, 256, timeout_ms);
        for (int i = 0; i < k; ++i) {
            Conn& c = conns[evs[i].data.u32];
            if (c.fd < 0) continue;
            if (evs[i].events & (EPOLLERR | EPOLLHUP)) {
                // DONE streams expect the server to hang up after Close
                if (c.phase == Conn::DONE) {
                    epoll_ctl(ep, EPOLL_CTL_DEL, c.fd, nullptr);
                    close(c.fd);
                    c.fd = -1;
                } else {
                    fail(c, "socket error/hup");
                }
                continue;
            }
            if (evs[i].events & EPOLLOUT) {
                if (c.phase == Conn::CONNECTING) {
                    int err = 0;
                    socklen_t el = sizeof err;
                    getsockopt(c.fd, SOL_SOCKET, SO_ERROR, &err, &el);
                    if (err) { fail(c, "connect failed"); continue; }
                    c.phase = Conn::HTTP;
                    queue_bytes(c, (const uint8_t*)upgrade_tail.data(),
                                upgrade_tail.size());
                }
                if (c.fd >= 0 && !flush_tx(c)) { fail(c, "send error");
                                                 continue; }
                if (c.fd >= 0) arm(c, !c.tx.empty());
            }
            if (c.fd >= 0 && (evs[i].events & EPOLLIN)) on_readable(c);
        }
    }

    // ---- report
    int n_ok = 0;
    auto fmt_lats = [](const std::vector<double>& v) {
        std::string s = "[";
        for (size_t i = 0; i < v.size(); ++i) {
            char b[32];
            snprintf(b, sizeof b, "%s%.4f", i ? "," : "", v[i]);
            s += b;
        }
        return s + "]";
    };
    for (auto& c : conns) {
        bool ok = c.phase == Conn::DONE;
        n_ok += ok;
        std::string extra;
        if (a.wake)
            extra = ",\"wake\":" + fmt_lats(c.wake_lat) +
                    ",\"enroll\":" + fmt_lats(c.enroll_lat);
        printf("{\"idx\":%d,\"ok\":%s,\"lat\":%s%s%s%s%s}\n", c.idx,
               ok ? "true" : "false", fmt_lats(c.lat).c_str(), extra.c_str(),
               c.fail_reason.empty() ? "" : ",\"err\":\"",
               c.fail_reason.c_str(),
               c.fail_reason.empty() ? "" : "\"");
    }
    printf("{\"summary\":{\"n\":%d,\"ok\":%d}}\n", a.n, n_ok);
    fflush(stdout);
    return 0;
}
