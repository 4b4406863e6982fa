// The span mark: one thread writes the card's %globaltimer (ns) into a
// program's stamp table, so that a span's entry and exit are timed where
// the work runs, replay after replay of a captured graph.
//
// Replaces no Pallas kernel: the reference's spans are the profiler's
// TraceAnnotations, which a replayed XLA program carries on the device;
// a replayed CUDA graph carries none, so the port stamps its own.
//
// The table is an int64 (rows, slots) tensor allocated once, before any
// capture, so a captured graph holds its address. The row is the
// program's own step counter, read at the mark, so every replay writes
// its own row without a host step between replays. A row outside the
// table writes nothing.

#include <stdint.h>

namespace nestmc {

__global__ void span_mark_kernel(long long* __restrict__ table,
                                 const long long* __restrict__ row, int slot,
                                 int slots, int rows) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long r = row[0];
  if (r < 0 || r >= rows) return;
  table[r * slots + slot] = (long long)now;
}

}  // namespace nestmc

// table: the int64 (rows, slots) stamp table in device memory; row: the
// int64 step counter in device memory; slot: the mark's column (0 <= slot
// < slots). Returns the cudaError_t of the launch (0 = success).
extern "C" int nestmc_span_mark(long long* table, const long long* row,
                                int slot, int slots, int rows, void* stream) {
  nestmc::span_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      table, row, slot, slots, rows);
  return (int)cudaGetLastError();
}
