// The center-finding tail of the batched line normalizer, shared by the two
// normalizer kernels: csrc/lineest_tail.cu defines it (three passes from the
// h-gauss output sm to center, dsum and dcnt) and launches it for the default
// route; csrc/lineest_full.cu computes sm from the ink mask first and then
// launches the same passes through this entry point. scratch (B, Hp, Wp) f32
// and keys (B, Wp) u64 are the caller's, held until the launches have run.
//
// Launches on `stream` and returns cudaGetLastError() (0 on success). See
// lineest_tail.cu for the layouts and the arithmetic.

#pragma once

extern "C" int ta_lineest_tail(const float* sm, const unsigned char* temp,
                               const int* hs, const int* ws, const double* k2,
                               int B, int Hp, int Wp, int K2, float* scratch,
                               unsigned long long* keys, int* center,
                               int* dsum, int* dcnt, int device,
                               void* stream);
