// Fast ACE ASCII tokenizer (the native-equivalent of the reference's
// Fortran ACE reader hot path; SURVEY.md section 2 'ACE reader': C++
// escalation path for host parse throughput at library scale).
//
// Parses whitespace-separated floating-point tokens (ACE XSS format,
// including Fortran-style exponents like 1.0D+05) from a byte buffer into
// a caller-provided double array. Exposed via a plain C ABI for ctypes.
//
// Built at first use by ndpp_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -o build/ndpp_tpu_torch/ace_tokenizer-<hash>.so ace_tokenizer.cpp

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Returns the number of tokens written (<= max_out), or -1 on a parse error.
// `consumed` (optional) receives the number of bytes consumed.
long long ndpp_tokenize(const char* buf, size_t len, double* out, size_t max_out,
                        size_t* consumed) {
    const char* p = buf;
    const char* end = buf + len;
    size_t n = 0;
    char tmp[64];
    while (p < end && n < max_out) {
        // skip whitespace
        while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t')) ++p;
        if (p >= end) break;
        // find token end
        const char* q = p;
        while (q < end && *q != ' ' && *q != '\n' && *q != '\r' && *q != '\t') ++q;
        size_t tl = (size_t)(q - p);
        if (tl == 0 || tl >= sizeof(tmp)) return -1;
        // copy + normalize Fortran exponents (D/d -> E)
        for (size_t i = 0; i < tl; ++i) {
            char c = p[i];
            if (c == 'D' || c == 'd') c = 'E';
            tmp[i] = c;
        }
        tmp[tl] = '\0';
        char* endp = nullptr;
        double v = strtod(tmp, &endp);
        if (endp == tmp || *endp != '\0') return -1;
        out[n++] = v;
        p = q;
    }
    if (consumed) *consumed = (size_t)(p - buf);
    return (long long)n;
}

// Count whitespace-separated tokens without parsing (for pre-allocation).
long long ndpp_count_tokens(const char* buf, size_t len) {
    const char* p = buf;
    const char* end = buf + len;
    long long n = 0;
    bool in_tok = false;
    while (p < end) {
        bool ws = (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t');
        if (!ws && !in_tok) { ++n; in_tok = true; }
        else if (ws) in_tok = false;
        ++p;
    }
    return n;
}

}  // extern "C"
