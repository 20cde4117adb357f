// Native runtime support for the SAR framework.
//
// Two host-side hot paths live here, off the Python GIL:
//
//  1. An asynchronous frame spiller: VideoSAR formation produces frames
//     faster than numpy.save can serialize them inline; a std::thread pool
//     writes .npy files (v1.0 format) in the background so the device loop
//     never stalls on disk (replaces the reference's synchronous per-frame
//     np.save at sar_batch_sim.py:328).
//
//  2. Run-length coverage statistics: constellation analyses
//     (distributed-spotlight scale: thousands of satellites, hundreds of
//     thousands of time steps) reduce a covered[T] mask to revisit/access
//     stats; the pure-Python loop is O(T) interpreter work.
//
// Built on demand with g++ (see native/__init__.py); exposed via ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// run-length coverage stats
// out[0]=coverage_fraction out[1]=mean_gap out[2]=max_gap
// out[3]=mean_access out[4]=num_accesses out[5]=num_gaps
// ---------------------------------------------------------------------------
void rle_stats(const uint8_t* covered, int64_t n, double dt, double* out) {
  if (n <= 0) { for (int i = 0; i < 6; i++) out[i] = 0.0; return; }
  int64_t covered_steps = 0;
  double gap_sum = 0.0, gap_max = 0.0, acc_sum = 0.0;
  int64_t n_gaps = 0, n_acc = 0;
  int64_t run = 1;
  uint8_t state = covered[0];
  for (int64_t i = 1; i <= n; i++) {
    uint8_t c = (i < n) ? covered[i] : (uint8_t)(2);  // sentinel flush
    if (i < n && c == state) { run++; continue; }
    double len = run * dt;
    if (state) { acc_sum += len; n_acc++; } else { gap_sum += len; n_gaps++; if (len > gap_max) gap_max = len; }
    if (i < n) { state = c; run = 1; }
  }
  for (int64_t i = 0; i < n; i++) covered_steps += covered[i] ? 1 : 0;
  out[0] = (double)covered_steps / (double)n;
  out[1] = n_gaps ? gap_sum / n_gaps : 0.0;
  out[2] = gap_max;
  out[3] = n_acc ? acc_sum / n_acc : 0.0;
  out[4] = (double)n_acc;
  out[5] = (double)n_gaps;
}

// ---------------------------------------------------------------------------
// per-satellite access accounting: counts[sat] += valid steps; first access
// time per sat (or -1). valid is (T x N) row-major uint8.
// ---------------------------------------------------------------------------
void per_sat_access(const uint8_t* valid, int64_t t_steps, int64_t n_sats,
                    double dt, double* counts_s, double* first_s) {
  for (int64_t s = 0; s < n_sats; s++) { counts_s[s] = 0.0; first_s[s] = -1.0; }
  for (int64_t t = 0; t < t_steps; t++) {
    const uint8_t* row = valid + t * n_sats;
    for (int64_t s = 0; s < n_sats; s++) {
      if (row[s]) {
        counts_s[s] += dt;
        if (first_s[s] < 0.0) first_s[s] = t * dt;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// async .npy frame spiller
// ---------------------------------------------------------------------------
namespace {

struct Job {
  std::string path;
  std::vector<char> bytes;   // full .npy file content
};

struct Spiller {
  std::vector<std::thread> workers;
  std::queue<Job> jobs;
  std::mutex mu;
  std::condition_variable cv, cv_done;
  std::atomic<int64_t> pending{0};
  std::atomic<int64_t> errors{0};
  bool stop = false;

  explicit Spiller(int n_threads) {
    for (int i = 0; i < n_threads; i++)
      workers.emplace_back([this] { this->run(); });
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return stop || !jobs.empty(); });
        if (jobs.empty()) { if (stop) return; else continue; }
        job = std::move(jobs.front());
        jobs.pop();
      }
      FILE* f = std::fopen(job.path.c_str(), "wb");
      if (!f) {
        errors.fetch_add(1);
      } else {
        size_t w = std::fwrite(job.bytes.data(), 1, job.bytes.size(), f);
        if (w != job.bytes.size()) errors.fetch_add(1);
        std::fclose(f);
      }
      // decrement + notify under the mutex: notifying outside it races with
      // a waiter that has checked the predicate but not yet blocked
      // (lost-wakeup), hanging spiller_wait() forever.
      {
        std::lock_guard<std::mutex> lk(mu);
        if (pending.fetch_sub(1) == 1) cv_done.notify_all();
      }
    }
  }

  void submit(Job&& job) {
    pending.fetch_add(1);
    {
      std::lock_guard<std::mutex> lk(mu);
      jobs.push(std::move(job));
    }
    cv.notify_one();
  }

  void wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [this] { return pending.load() == 0; });
  }

  ~Spiller() {
    wait();
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& t : workers) t.join();
  }
};

std::vector<char> npy_file(const float* data, int64_t n_floats, int ndim,
                           const int64_t* shape, int is_complex) {
  std::string dict = "{'descr': '";
  dict += is_complex ? "<c8" : "<f4";
  dict += "', 'fortran_order': False, 'shape': (";
  for (int i = 0; i < ndim; i++) {
    dict += std::to_string(shape[i]);
    if (i + 1 < ndim) dict += ", ";
  }
  if (ndim == 1) dict += ",";
  dict += "), }";
  size_t header_len = 10 + dict.size() + 1;           // magic+ver+len + dict + \n
  size_t pad = (64 - (header_len % 64)) % 64;
  dict.append(pad, ' ');
  dict += '\n';
  uint16_t hlen = (uint16_t)dict.size();

  std::vector<char> out;
  out.reserve(10 + dict.size() + n_floats * 4);
  const char magic[] = "\x93NUMPY\x01\x00";
  out.insert(out.end(), magic, magic + 8);
  out.push_back((char)(hlen & 0xff));
  out.push_back((char)(hlen >> 8));
  out.insert(out.end(), dict.begin(), dict.end());
  const char* raw = reinterpret_cast<const char*>(data);
  out.insert(out.end(), raw, raw + n_floats * 4);
  return out;
}

}  // namespace

void* spiller_create(int n_threads) {
  return new Spiller(n_threads > 0 ? n_threads : 2);
}

int spiller_submit(void* h, const char* path, const float* data,
                   int64_t n_floats, int ndim, const int64_t* shape,
                   int is_complex) {
  auto* s = static_cast<Spiller*>(h);
  Job job;
  job.path = path;
  job.bytes = npy_file(data, n_floats, ndim, shape, is_complex);
  s->submit(std::move(job));
  return 0;
}

int64_t spiller_pending(void* h) {
  return static_cast<Spiller*>(h)->pending.load();
}

int64_t spiller_errors(void* h) {
  return static_cast<Spiller*>(h)->errors.load();
}

void spiller_wait(void* h) { static_cast<Spiller*>(h)->wait(); }

void spiller_destroy(void* h) { delete static_cast<Spiller*>(h); }

}  // extern "C"
