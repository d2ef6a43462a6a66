// Device spans: the stamp kernel of engine/spans.py.  Plain C interface,
// loaded with ctypes.
//
// One thread reads the device's global nanosecond clock (%globaltimer) and
// writes it into row counter[0] + row_offset, column col, of an int64 stamp
// table of `stride` columns.  The counter is the step counter of the step
// graph's buffers, so a stamp captured into a CUDA graph lands in the row
// of the step that replays it.  Kernels on one stream run one after the
// other, so the stamp is taken once every node enqueued before it has
// ended and before any node enqueued after it starts.

#include <cuda_runtime.h>

namespace {

__global__ void spans_stamp_kernel(long long* table, const long long* counter, int stride,
                                   int col, int row_offset) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  table[(counter[0] + row_offset) * stride + col] = (long long)t;
}

}  // namespace

extern "C" {

const char* cg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int spans_stamp(void* table, const void* counter, int stride, int col, int row_offset,
                void* stream) {
  spans_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (long long*)table, (const long long*)counter, stride, col, row_offset);
  return (int)cudaGetLastError();
}

}  // extern "C"
