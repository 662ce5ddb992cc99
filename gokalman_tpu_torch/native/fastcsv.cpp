// Native CSV formatting/parsing for estimate traces.
//
// The reference streams estimates to CSV via fmt.Sprintf("%f", ...)
// (exporter.go:34-45); this framework's equivalent hot path is bulk
// export of Monte-Carlo trace matrices (montecarlo.go:62-89 writes
// runs x steps values per state component).  Python-level float
// formatting runs at ~1-2M values/s; this formatter is ~30-60M/s and
// byte-compatible with printf("%f") (which Python's f"{x:f}" also is).
//
// Build: gokalman_tpu_torch/native/__init__.py compiles this file with
// g++ -O3 -shared -fPIC into build/native/ at first use.
// ABI: plain C functions, consumed via ctypes — no pybind11 needed.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

inline long write_u64(unsigned long long v, char* out) {
    char tmp[24];
    int n = 0;
    do {
        tmp[n++] = char('0' + v % 10);
        v /= 10;
    } while (v);
    for (int i = 0; i < n; ++i) out[i] = tmp[n - 1 - i];
    return n;
}

// printf("%f")-exact fixed-6 formatter.  Fast integer path for
// |v| < 1e6; anything larger, non-finite, or within the rounding
// guard band (where the double arithmetic here could disagree with
// printf's correctly-rounded conversion) falls back to snprintf.
// Guard analysis: for |v| < 1e6, scaled < 1e12 so the error of
// scaled = v*1e6 is <= ~2 ulp ~= 2.4e-4 digit units; any true digit
// remainder outside (0.499, 0.501) therefore rounds identically.
inline long fmt6(double v, char* out, long avail) {
    // %f of the largest double needs ~316 chars; require headroom on
    // any snprintf fallback and report overflow with -1.
    if (!(v < 1e6 && v > -1e6)) {
        if (avail < 340) return -1;
        return snprintf(out, 340, "%f", v);
    }
    bool neg = std::signbit(v);
    double av = neg ? -v : v;
    double scaled = av * 1e6;
    double fl = std::floor(scaled);
    double d = scaled - fl;
    if (d > 0.499 && d < 0.501) return snprintf(out, 32, "%f", v);
    unsigned long long q =
        (unsigned long long)fl + (d >= 0.5 ? 1ull : 0ull);
    unsigned long long ip = q / 1000000ull, fp = q % 1000000ull;
    char* p = out;
    if (neg) *p++ = '-';
    p += write_u64(ip, p);
    *p++ = '.';
    for (int i = 5; i >= 0; --i) {
        p[i] = char('0' + fp % 10);
        fp /= 10;
    }
    p += 6;
    return long(p - out);
}

}  // namespace

extern "C" {

// Format a dense [rows, cols] row-major double matrix as CSV with
// printf("%f") (6 fractional digits), '\n' row terminators.  Returns
// the number of bytes written, or -1 if `cap` would be exceeded.
long fastcsv_format(const double* data, long rows, long cols,
                    char* out, long cap) {
    long pos = 0;
    for (long r = 0; r < rows; ++r) {
        for (long c = 0; c < cols; ++c) {
            if (pos + 32 > cap) return -1;
            if (c) out[pos++] = ',';
            long k = fmt6(data[r * cols + c], out + pos, cap - pos);
            if (k < 0) return -1;
            pos += k;
        }
        if (pos + 1 > cap) return -1;
        out[pos++] = '\n';
    }
    return pos;
}

// Parse comma/newline-separated floats from `text` (len bytes) into
// `out` (capacity cap values).  "NaN"/"nan" parse as NaN.  Returns the
// number of values parsed, or -1 on capacity overflow.
long fastcsv_parse(const char* text, long len, double* out, long cap) {
    long count = 0;
    const char* p = text;
    const char* end = text + len;
    while (p < end) {
        // Skip separators/whitespace.
        while (p < end && (*p == ',' || *p == '\n' || *p == '\r' ||
                           *p == ' ' || *p == '\t'))
            ++p;
        if (p >= end) break;
        char* next = nullptr;
        double v = strtod(p, &next);
        if (next == p) {  // unparseable token: skip to next separator
            while (p < end && *p != ',' && *p != '\n') ++p;
            continue;
        }
        if (count >= cap) return -1;
        out[count++] = v;
        p = next;
    }
    return count;
}

}  // extern "C"
