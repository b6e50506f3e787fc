// Native partition splitter of the coordinator's streamed upload: the
// port's copy of the JAX package's native row splitter, after the reference's
// C++ streamed splitter (reference src/service/storage_service.cpp:100-150;
// row framing at :19-28: [u32 LE size][payload], a stored row includes its
// header).
//
// Host code, built with the host compiler by ops/kernels/_build.py and loaded
// with ctypes by utils/rowcodec.py (a plain C interface).  Two departures
// from the JAX package's copy, so that a failing chunk leaves what the
// Python splitter leaves:
// - `state` is written back before every return: the rows appended before
//   a failure stay counted, as the Python splitter counts them row by row;
// - each failure has its own code (a truncated header, a truncated payload,
//   an overrun, an I/O error with its errno), so the caller raises what the
//   Python splitter raises.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

constexpr int64_t kTruncatedHeader = -1;
constexpr int64_t kOverrun = -2;
constexpr int64_t kIoError = -3;
constexpr int64_t kTruncatedPayload = -4;

}  // namespace

extern "C" {

// Appends a chunk of framed rows to the partition files, rolling to the next
// partition when one holds its capacity.
//   data/size:  the chunk
//   frame_dir:  directory holding the partition files "0", "1", ...
//   state:      [current_partition, rows_stored_in_partition], in and out;
//               written back on every return
//   max_rows:   each partition's capacity in rows, length `partitions`
//   os_error:   out, the errno of a failed open or write
// Returns the rows consumed, or -1 (truncated header), -2 (overrun: every
// partition full), -3 (I/O error on partition state[0]), -4 (truncated
// payload).
int64_t hm_split_rows(const char* data, size_t size, const char* frame_dir,
                      int64_t* state, const int64_t* max_rows,
                      int64_t partitions, int* os_error) {
    int64_t current = state[0];
    int64_t stored = state[1];
    int64_t rows_read = 0;
    int64_t status = 0;
    size_t off = 0;
    *os_error = 0;

    while (off < size && status == 0) {
        if (current >= partitions) {
            status = kOverrun;
            break;
        }
        const std::string path =
            std::string(frame_dir) + "/" + std::to_string(current);
        FILE* f = std::fopen(path.c_str(), "ab");
        if (f == nullptr) {
            *os_error = errno;
            status = kIoError;
            break;
        }
        const int64_t cap = max_rows[current];
        while (off < size) {
            if (size - off < 4) {
                status = kTruncatedHeader;
                break;
            }
            uint32_t row_size = 0;
            std::memcpy(&row_size, data + off, 4);
            const size_t total = 4 + static_cast<size_t>(row_size);
            if (size - off < total) {
                status = kTruncatedPayload;
                break;
            }
            if (std::fwrite(data + off, 1, total, f) != total) {
                *os_error = errno;
                status = kIoError;
                break;
            }
            off += total;
            ++rows_read;
            ++stored;
            if (stored == cap) {
                ++current;
                stored = 0;
                break;
            }
        }
        if (std::fclose(f) != 0 && status == 0) {
            *os_error = errno;
            status = kIoError;
        }
    }

    state[0] = current;
    state[1] = stored;
    return status != 0 ? status : rows_read;
}

}  // extern "C"
