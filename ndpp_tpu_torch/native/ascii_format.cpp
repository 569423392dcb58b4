// Fixed-width text of float64 values for the ASCII library: the value lines
// of docs/format.md's layout, byte for byte what the writer's Python loop
// writes. Exposed via a plain C ABI for ctypes, which calls it without the
// interpreter lock.
//
// The value token, as both paths write it: the 26 bytes of Python's
// f"{v:26.17E}", right-justified with spaces (the longest token,
// -1.23456789012345678E-308, is 25, so at least one space separates two).
// A finite value is a '-' when negative, one digit, a point and 17 digits,
// correctly rounded with ties to even, an upper-case E, the exponent's sign
// and at least two exponent digits (E+05, E-310); negative zero keeps its
// sign, and subnormals are written like any value, down to
// 4.94065645841246544E-324. Every NaN is NAN, unsigned whatever its sign bit
// (glibc's %E would write -NAN); the infinities are INF and -INF. Four
// tokens and '\n' make a line of 105 bytes; an array of n values ends with a
// short line of n % 4 tokens when that is not 0, and an empty one writes
// nothing.
//
// Built at first use by ndpp_tpu_torch/native/__init__.py:
//   g++ -O3 -std=c++17 -shared -fPIC -o build/ndpp_tpu_torch/ascii_format-<hash>.so ascii_format.cpp
// A library without floating-point std::to_chars fails the build, and the
// writer then takes its Python loop.

#include <charconv>
#include <cmath>
#include <cstddef>
#include <cstring>

namespace {

constexpr int kWidth = 26;  // sign + 19-character mantissa + E + sign + 3 digits is 25

// A finite value as printf's "%.17E". Returns its length, at most 25.
inline int scientific17(double v, char* buf) {
    char* end = std::to_chars(buf, buf + 32, v, std::chars_format::scientific, 17).ptr;
    // to_chars writes a lower-case e, after the sign, the leading digit, the point and 17 digits
    buf[std::signbit(v) ? 20 : 19] = 'E';
    return static_cast<int>(end - buf);
}

inline void put(double v, char* field) {
    char buf[32];
    int len;
    if (std::isnan(v)) {
        std::memcpy(buf, "NAN", 3);  // Python writes no sign for a NaN, whatever its sign bit
        len = 3;
    } else if (std::isinf(v)) {
        len = v < 0 ? 4 : 3;
        std::memcpy(buf, v < 0 ? "-INF" : "INF", len);
    } else {
        len = scientific17(v, buf);
    }
    std::memset(field, ' ', kWidth - len);
    std::memcpy(field + kWidth - len, buf, len);
}

}  // namespace

extern "C" {

// Writes the n values of v as the format's value lines into out, which holds
// at least (n / 4) * 105 + 26 * (n % 4) + 1 bytes; returns the bytes written.
size_t ndpp_format_values(const double* v, size_t n, char* out) {
    char* p = out;
    for (size_t i = 0; i < n; ++i) {
        put(v[i], p);
        p += kWidth;
        if (i % 4 == 3 || i + 1 == n) *p++ = '\n';
    }
    return static_cast<size_t>(p - out);
}

}  // extern "C"
