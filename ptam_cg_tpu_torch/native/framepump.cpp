// framepump: native asynchronous frame loader for dataset replay.
//
// TPU-native counterpart of the reference's VideoSource layer
// (ref: src/VideoSource.cc:59-159 VideoSourceDataSet): where the C++
// reference reads+converts frames synchronously on the tracking thread,
// this library runs a prefetch worker thread that decodes frames into a
// bounded ring buffer so host IO overlaps device compute. Exposed to
// Python via a plain C ABI (ctypes).
//
// Supported frame formats: raw .npy (float32/uint8, C-order, 2-D) and
// binary PGM (P5). Frames are delivered as float32 grayscale in
// [0, 255].
//
// Build: g++ -O3 -march=native -shared -fPIC -o libframepump.so
//        framepump.cpp -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <mutex>
#include <queue>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  double timestamp = 0.0;
  int height = 0;
  int width = 0;
  std::vector<float> data;
  bool ok = false;
};

// ---------------------------------------------------------------------
// Decoders
// ---------------------------------------------------------------------

bool load_npy(const std::string& path, Frame* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  char magic[6];
  f.read(magic, 6);
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  uint8_t ver[2];
  f.read(reinterpret_cast<char*>(ver), 2);
  uint32_t header_len = 0;
  if (ver[0] == 1) {
    uint16_t hl;
    f.read(reinterpret_cast<char*>(&hl), 2);
    header_len = hl;
  } else {
    f.read(reinterpret_cast<char*>(&header_len), 4);
  }
  std::string header(header_len, '\0');
  f.read(&header[0], header_len);

  const bool is_f32 = header.find("<f4") != std::string::npos;
  const bool is_u8 = header.find("|u1") != std::string::npos;
  if (!is_f32 && !is_u8) return false;
  if (header.find("'fortran_order': False") == std::string::npos)
    return false;
  auto sp = header.find("'shape': (");
  if (sp == std::string::npos) return false;
  int h = 0, w = 0;
  if (sscanf(header.c_str() + sp, "'shape': (%d, %d)", &h, &w) != 2)
    return false;

  out->height = h;
  out->width = w;
  out->data.resize(static_cast<size_t>(h) * w);
  if (is_f32) {
    f.read(reinterpret_cast<char*>(out->data.data()),
           out->data.size() * sizeof(float));
  } else {
    std::vector<uint8_t> tmp(out->data.size());
    f.read(reinterpret_cast<char*>(tmp.data()), tmp.size());
    for (size_t i = 0; i < tmp.size(); ++i)
      out->data[i] = static_cast<float>(tmp[i]);
  }
  out->ok = static_cast<bool>(f);
  return out->ok;
}

bool load_pgm(const std::string& path, Frame* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  std::string magic;
  f >> magic;
  if (magic != "P5") return false;
  int w = 0, h = 0, maxv = 0;
  // Skip comments.
  auto next_int = [&](int* v) {
    while (true) {
      f >> std::ws;
      if (f.peek() == '#') {
        std::string line;
        std::getline(f, line);
      } else {
        f >> *v;
        return;
      }
    }
  };
  next_int(&w);
  next_int(&h);
  next_int(&maxv);
  f.get();  // single whitespace after header
  out->height = h;
  out->width = w;
  out->data.resize(static_cast<size_t>(h) * w);
  std::vector<uint8_t> tmp(out->data.size());
  f.read(reinterpret_cast<char*>(tmp.data()), tmp.size());
  const float scale = maxv > 0 ? 255.0f / maxv : 1.0f;
  for (size_t i = 0; i < tmp.size(); ++i)
    out->data[i] = tmp[i] * scale;
  out->ok = static_cast<bool>(f);
  return out->ok;
}

bool load_frame(const std::string& path, Frame* out) {
  if (path.size() >= 4 &&
      path.compare(path.size() - 4, 4, ".npy") == 0)
    return load_npy(path, out);
  if (path.size() >= 4 &&
      path.compare(path.size() - 4, 4, ".pgm") == 0)
    return load_pgm(path, out);
  return false;
}

// ---------------------------------------------------------------------
// Prefetching pump
// ---------------------------------------------------------------------

struct Pump {
  std::vector<std::pair<double, std::string>> entries;
  size_t next_to_load = 0;
  size_t capacity = 4;
  bool loop = true;
  std::queue<Frame> ready;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_space;
  std::atomic<bool> stop{false};
  std::thread worker;

  void run() {
    while (!stop.load()) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() || ready.size() < capacity;
        });
        if (stop.load()) return;
        if (next_to_load >= entries.size()) {
          if (!loop) {
            Frame sentinel;  // ok=false marks end of stream
            ready.push(std::move(sentinel));
            cv_ready.notify_all();
            return;
          }
          next_to_load = 0;
        }
        idx = next_to_load++;
      }
      Frame fr;
      fr.timestamp = entries[idx].first;
      load_frame(entries[idx].second, &fr);
      {
        std::unique_lock<std::mutex> lk(mu);
        ready.push(std::move(fr));
        cv_ready.notify_all();
      }
    }
  }
};

bool parse_index(const std::string& root, Pump* p) {
  std::ifstream f(root + "/rgb.txt");
  if (!f) return false;
  std::string line;
  while (std::getline(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ss(line);
    double ts;
    std::string rel;
    if (!(ss >> ts >> rel)) continue;
    p->entries.emplace_back(ts, root + "/" + rel);
  }
  return !p->entries.empty();
}

}  // namespace

extern "C" {

void* fp_open(const char* root, int prefetch, int loop) {
  auto* p = new Pump;
  p->capacity = prefetch > 0 ? prefetch : 4;
  p->loop = loop != 0;
  if (!parse_index(root, p)) {
    delete p;
    return nullptr;
  }
  p->worker = std::thread([p] { p->run(); });
  return p;
}

int fp_count(void* handle) {
  return static_cast<int>(static_cast<Pump*>(handle)->entries.size());
}

// Blocks until the next frame is decoded. Returns 0 on success, -1 at
// end-of-stream (non-looping), -2 on decode error, -3 if the caller's
// buffer is too small. On success fills h/w/timestamp and copies the
// float32 pixels into buf (caller-allocated, buf_len floats).
int fp_next(void* handle, float* buf, int buf_len, int* h, int* w,
            double* timestamp) {
  auto* p = static_cast<Pump*>(handle);
  Frame fr;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_ready.wait(lk, [&] { return !p->ready.empty(); });
    fr = std::move(p->ready.front());
    p->ready.pop();
    p->cv_space.notify_all();
  }
  if (!fr.ok && fr.data.empty() && fr.height == 0) return -1;
  if (!fr.ok) return -2;
  if (static_cast<int>(fr.data.size()) > buf_len) return -3;
  *h = fr.height;
  *w = fr.width;
  *timestamp = fr.timestamp;
  memcpy(buf, fr.data.data(), fr.data.size() * sizeof(float));
  return 0;
}

void fp_close(void* handle) {
  auto* p = static_cast<Pump*>(handle);
  p->stop.store(true);
  p->cv_space.notify_all();
  p->cv_ready.notify_all();
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

}  // extern "C"
