// Chrome-tracing timeline writer with a dedicated writer thread (the port's
// copy of the JAX package's _native/csrc/timeline.cc, plus hvd_tl_now_us).
//
// Native analogue of the reference TimelineWriter (horovod/common/
// timeline.{h,cc}: record queue drained by a writer thread). Submitting
// threads pay a mutex push of a pre-sized record; JSON formatting and file
// I/O happen on the writer thread. The queue is unbounded and nothing
// counts drops (there are none); a disk slower than the emit rate costs
// memory, unlike the Python RecordWriter's bounded queue.
// Events stream to disk continuously so a killed job still leaves a loadable
// trace (chrome tracing tolerates a missing closing bracket). The per-tensor
// state machine stays in Python (timeline.py); this layer owns tids,
// timestamps (steady_clock relative to creation, read by hvd_tl_now_us so a
// device-trace splice can stand on the same clock) and the file.
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>

#include "common.hpp"

namespace {

using Clock = std::chrono::steady_clock;

struct Record {
  std::string name;
  char ph;            // B, E, i, M
  int32_t tid;
  double ts_us;
  std::string args_json;  // pre-rendered JSON object ("" = none)
  bool meta_thread_name;  // M record: args = {"name": name}
};

struct Timeline {
  std::FILE* f = nullptr;
  Clock::time_point t0;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Record> q;
  bool closing = false;
  std::thread writer;
  std::mutex tid_mu;
  std::unordered_map<std::string, int32_t> tids;
  int32_t next_tid = 1;

  double now_us() {
    return std::chrono::duration<double, std::micro>(Clock::now() - t0)
        .count();
  }

  void push(Record&& r) {
    {
      std::lock_guard<std::mutex> lk(mu);
      if (closing) return;
      q.push_back(std::move(r));
    }
    cv.notify_one();
  }

  static void json_escape(const std::string& in, std::string* out) {
    for (char c : in) {
      switch (c) {
        case '"': *out += "\\\""; break;
        case '\\': *out += "\\\\"; break;
        case '\n': *out += "\\n"; break;
        case '\t': *out += "\\t"; break;
        default:
          if ((unsigned char)c < 0x20) {
            char buf[8];
            std::snprintf(buf, sizeof buf, "\\u%04x", c);
            *out += buf;
          } else {
            *out += c;
          }
      }
    }
  }

  void write_record(const Record& r) {
    std::string name;
    json_escape(r.name, &name);
    char head[160];
    if (r.ph == 'M') {
      std::fprintf(f,
                   "{\"name\": \"thread_name\", \"ph\": \"M\", \"pid\": 0, "
                   "\"tid\": %d, \"args\": {\"name\": \"%s\"}},\n",
                   r.tid, name.c_str());
      return;
    }
    std::snprintf(head, sizeof head,
                  "{\"name\": \"%s\", \"ph\": \"%c\", \"pid\": 0, "
                  "\"tid\": %d, \"ts\": %.3f",
                  name.c_str(), r.ph, r.tid, r.ts_us);
    std::fputs(head, f);
    if (r.ph == 'i') std::fputs(", \"s\": \"g\"", f);
    if (!r.args_json.empty()) {
      std::fputs(", \"args\": ", f);
      std::fputs(r.args_json.c_str(), f);
    }
    std::fputs("},\n", f);
  }

  void run() {
    std::fputs("[\n", f);
    int64_t n = 0;
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv.wait(lk, [&] { return !q.empty() || closing; });
      while (!q.empty()) {
        Record r = std::move(q.front());
        q.pop_front();
        lk.unlock();
        write_record(r);
        if (++n % 64 == 0) std::fflush(f);
        lk.lock();
      }
      if (closing) break;
      lk.unlock();
      std::fflush(f);
      lk.lock();
    }
    lk.unlock();
    std::fputs("{}]\n", f);
    std::fclose(f);
  }
};

}  // namespace

HVD_EXPORT void* hvd_tl_create(const char* path) {
  auto* tl = new Timeline();
  tl->f = std::fopen(path, "w");
  if (!tl->f) {
    delete tl;
    return nullptr;
  }
  tl->t0 = Clock::now();
  tl->writer = std::thread([tl] { tl->run(); });
  return tl;
}

// Registers `tensor` on first use (emitting the thread_name metadata record)
// and returns its tid.
HVD_EXPORT int32_t hvd_tl_tid(void* p, const char* tensor) {
  auto* tl = static_cast<Timeline*>(p);
  int32_t tid;
  bool fresh = false;
  {
    std::lock_guard<std::mutex> lk(tl->tid_mu);
    auto it = tl->tids.find(tensor);
    if (it != tl->tids.end()) {
      tid = it->second;
    } else {
      tid = tl->next_tid++;
      tl->tids.emplace(tensor, tid);
      fresh = true;
    }
  }
  if (fresh) tl->push(Record{tensor, 'M', tid, 0.0, "", true});
  return tid;
}

// Microseconds since creation on the clock that stamps every record.
HVD_EXPORT double hvd_tl_now_us(void* p) {
  return static_cast<Timeline*>(p)->now_us();
}

// ph: "B" begin, "E" end, "i" instant. args_json may be NULL.
HVD_EXPORT void hvd_tl_emit(void* p, const char* name, const char* ph,
                            int32_t tid, const char* args_json) {
  auto* tl = static_cast<Timeline*>(p);
  tl->push(Record{name ? name : "", ph[0], tid, tl->now_us(),
                  args_json ? args_json : "", false});
}

HVD_EXPORT void hvd_tl_close(void* p) {
  auto* tl = static_cast<Timeline*>(p);
  {
    std::lock_guard<std::mutex> lk(tl->mu);
    tl->closing = true;
  }
  tl->cv.notify_one();
  tl->writer.join();
  delete tl;
}
