// tpu_timer: native profiling/hang-detection runtime of a training
// process (the port's copy of dlrover_tpu/native/tpu_timer/tpu_timer.h,
// with the same C ABI).
//
// Parity: reference xpu_timer/common/manager.h (GpuTimerManager:106,
// KernelTraceManager:50) and server/hosting_service_server_client.h.
// Timings arrive through an explicit C ABI fed by the Python bridge
// (step spans, checkpoint phases, GC pauses, and the device kernels a
// torch.profiler window captured). The native layer owns what must not
// depend on a (possibly hung) Python runtime: the lock-light trace
// ring, metric aggregation, the Prometheus/timeline HTTP daemon, and
// the hang watchdog.
//
// C ABI (stable, used via ctypes):
//   tt_init(hang_timeout_ms)        -> 0 ok
//   tt_start_server(port)           -> bound port (0 on failure)
//   tt_begin(name, kind)            -> span id (thread-safe)
//   tt_end(span_id, flops)          -> records duration + flops
//   tt_record(name, kind, start_ns, dur_ns, flops) -> out-of-band event
//   tt_set_gauge(name, value)
//   tt_counter_add(name, delta)
//   tt_hang_count()                 -> spans currently over the timeout
//   tt_dump_timeline(path)          -> chrome-trace JSON (perfetto-loadable)
//   tt_metrics_text(buf, cap)       -> Prometheus text exposition
//   tt_shutdown()

#ifndef DLROVER_TPU_TIMER_H_
#define DLROVER_TPU_TIMER_H_

#include <cstdint>

extern "C" {

int tt_init(int64_t hang_timeout_ms);
int tt_start_server(int port);
int64_t tt_begin(const char* name, int kind);
void tt_end(int64_t span_id, double flops);
void tt_record(const char* name, int kind, int64_t start_ns, int64_t dur_ns,
               double flops);
void tt_set_gauge(const char* name, double value);
void tt_counter_add(const char* name, double delta);
int tt_hang_count();
int64_t tt_now_ns();
int tt_dump_timeline(const char* path);
// Returns bytes written (excluding NUL); negative if cap too small.
int tt_metrics_text(char* buf, int cap);
void tt_shutdown();

}  // extern "C"

#endif  // DLROVER_TPU_TIMER_H_
