// Native I/O runtime of thermalporous_torch (bound with ctypes by
// thermalporous_torch/io/native.py, which builds this file at first use into
// thermalporous_torch/_build/):
//
//   - tp_parse_floats: whitespace-separated float parsing (the SPE10 text
//                      datasets hold 4.5M tokens);
//   - tp_write_vti:    the VTI raw-appended writer (header, length-prefixed
//                      blocks and footer in one streamed pass).
//
// By hand: c++ -O3 -fPIC -std=c++17 -Wall -shared -o libtp_io.so tp_io.cc

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse up to n whitespace-separated doubles from path into out.
// Returns the number parsed, or -1 on open failure.
long tp_parse_floats(const char* path, double* out, long n) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    char* buf = static_cast<char*>(std::malloc(size + 1));
    if (!buf) { std::fclose(f); return -1; }
    long got = static_cast<long>(std::fread(buf, 1, size, f));
    std::fclose(f);
    buf[got] = '\0';

    long count = 0;
    char* p = buf;
    char* end = buf + got;
    while (count < n && p < end) {
        char* next = nullptr;
        double v = std::strtod(p, &next);
        if (next == p) {  // not a number: skip one byte (separator run)
            ++p;
            continue;
        }
        out[count++] = v;
        p = next;
    }
    std::free(buf);
    return count;
}

// Write a VTI file: XML header, '_' marker, then for each array a uint64
// little-endian byte count followed by the raw payload, then the footer.
// Returns 0 on success.
int tp_write_vti(const char* path, const char* header,
                 const unsigned char** arrays, const uint64_t* nbytes,
                 int narrays, const char* footer) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    if (std::fwrite(header, 1, std::strlen(header), f) != std::strlen(header)) {
        std::fclose(f);
        return -2;
    }
    for (int i = 0; i < narrays; ++i) {
        uint64_t len = nbytes[i];
        if (std::fwrite(&len, sizeof(uint64_t), 1, f) != 1) { std::fclose(f); return -3; }
        if (len && std::fwrite(arrays[i], 1, len, f) != len) { std::fclose(f); return -4; }
    }
    if (std::fwrite(footer, 1, std::strlen(footer), f) != std::strlen(footer)) {
        std::fclose(f);
        return -5;
    }
    std::fclose(f);
    return 0;
}

}  // extern "C"
