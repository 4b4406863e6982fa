// Fast CSV -> ragged-array ingest for nestmc_torch (the native data-loader
// tier; the port's own copy of the JAX package's native/ingest.cpp).
//
// Parses a headerless CSV of numeric rows (group_id, y, x_1..x_p) into
// caller-allocated flat arrays (segment representation: nestmc_torch/data.py
// RaggedData). Rows must be grouped by group_id (any sorted or contiguous
// order); group ids are remapped to dense 0..G-1 in first-appearance order.
//
// Exposed as a C ABI for ctypes (no pybind11 dependency). Two-pass
// design: pass 1 counts rows/validates, pass 2 fills buffers. The parser is
// a single forward scan with manual float parsing (strtod on slices), no
// allocations per field.
//
// Build: see nestmc_torch/io/build.py (g++ -O3 -shared -fPIC).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Returns: 0 ok; -1 cannot open; -2 parse error; -3 inconsistent columns.
// Pass 1: n_cols/n_rows/n_groups are outputs; buffers may be null.
// Pass 2: fills y (n_rows), x (n_rows * (n_cols-2)), segment_ids (n_rows).
int nestmc_ingest_csv(
    const char* path,
    int64_t* n_rows_out,
    int64_t* n_cols_out,
    int64_t* n_groups_out,
    float* y_out,          // may be null (pass 1)
    float* x_out,          // may be null
    int32_t* seg_out,      // may be null
    int64_t* err_line_out  // line number of a parse error
) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;

    // Read the whole file (nested-data CSVs are at most a few GB; stream in
    // 64MB chunks to keep peak memory bounded when only counting).
    const size_t CHUNK = 1 << 26;
    char* buf = static_cast<char*>(std::malloc(CHUNK + 2));
    if (!buf) { std::fclose(f); return -2; }

    const bool fill = (y_out != nullptr);
    int64_t n_rows = 0, n_cols = -1, n_groups = 0;
    int64_t line_no = 0;
    double last_gid = -1.0;
    bool have_last_gid = false;

    // carry holds a partial line across chunk boundaries
    char carry[8192];
    size_t carry_len = 0;
    int rc = 0;

    while (true) {
        size_t got = std::fread(buf, 1, CHUNK, f);
        if (got == 0 && carry_len == 0) break;
        // assemble: carry + chunk
        size_t total = carry_len + got;
        char* data;
        char* assembled = nullptr;
        if (carry_len) {
            assembled = static_cast<char*>(std::malloc(total + 2));
            if (!assembled) { rc = -2; break; }
            std::memcpy(assembled, carry, carry_len);
            std::memcpy(assembled + carry_len, buf, got);
            data = assembled;
            carry_len = 0;
        } else {
            data = buf;
        }
        bool is_last = (got < CHUNK);
        if (is_last) { data[total] = '\n'; total += 1; }

        size_t pos = 0;
        while (pos < total) {
            // find end of line
            char* nl = static_cast<char*>(
                std::memchr(data + pos, '\n', total - pos));
            if (!nl) {
                // partial line: stash into carry
                size_t rem = total - pos;
                if (rem >= sizeof(carry)) { rc = -2; break; }
                std::memcpy(carry, data + pos, rem);
                carry_len = rem;
                break;
            }
            size_t len = static_cast<size_t>(nl - (data + pos));
            char* line = data + pos;
            pos += len + 1;
            line_no++;
            // strip \r, skip empty lines
            while (len && (line[len - 1] == '\r' || line[len - 1] == ' '))
                len--;
            if (len == 0) continue;
            line[len] = '\0';

            // parse comma-separated doubles
            int64_t col = 0;
            char* s = line;
            double gid = 0.0, yv = 0.0;
            while (true) {
                char* end = nullptr;
                errno = 0;
                double v = std::strtod(s, &end);
                if (end == s) {
                    rc = -2; *err_line_out = line_no; break;
                }
                if (col == 0) gid = v;
                else if (col == 1) yv = v;
                else if (fill) {
                    x_out[n_rows * (n_cols - 2) + (col - 2)] =
                        static_cast<float>(v);
                }
                col++;
                while (*end == ' ') end++;
                if (*end == ',') { s = end + 1; continue; }
                if (*end == '\0') break;
                rc = -2; *err_line_out = line_no; break;
            }
            if (rc) break;
            if (n_cols < 0) {
                n_cols = col;
                if (n_cols < 2) { rc = -3; break; }
            } else if (col != n_cols) {
                rc = -3; *err_line_out = line_no; break;
            }
            if (!have_last_gid || gid != last_gid) {
                n_groups++;
                last_gid = gid;
                have_last_gid = true;
            }
            if (fill) {
                y_out[n_rows] = static_cast<float>(yv);
                seg_out[n_rows] = static_cast<int32_t>(n_groups - 1);
            }
            n_rows++;
        }
        if (assembled) std::free(assembled);
        if (rc || is_last) break;
    }

    std::free(buf);
    std::fclose(f);
    if (rc) return rc;
    *n_rows_out = n_rows;
    *n_cols_out = n_cols < 0 ? 0 : n_cols;
    *n_groups_out = n_groups;
    return 0;
}

}  // extern "C"
