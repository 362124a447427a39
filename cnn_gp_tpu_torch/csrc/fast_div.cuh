// Unsigned division by a divisor fixed at launch, for the index
// arithmetic of the layer kernels and their adjoints: a 32-bit division
// by a runtime value costs about 20 instructions, this one a multiply-high
// and a shift (Granlund and Montgomery, "Division by invariant integers
// using multiplication", 1994, theorem 4.2, with N = 31).
//
// For a divisor d with 2^(l-1) < d <= 2^l, m = ceil(2^(31+l) / d) < 2^32
// and floor(n / d) = floor(n m / 2^(31+l)) = umulhi(n, m) >> (l - 1) for
// every n < 2^31; the launchers refuse index ranges of 2^31 or more.

#pragma once

#include <cstdint>

struct FastDiv {
  unsigned d;
  unsigned m;
  int s;
};

inline FastDiv make_fast_div(unsigned d) {
  if (d <= 1) return FastDiv{1u, 0u, 0};
  int l = 0;
  while ((1ull << l) < d) ++l;
  const unsigned long long m = ((1ull << (31 + l)) + d - 1) / d;
  return FastDiv{d, static_cast<unsigned>(m), l - 1};
}

__device__ __forceinline__ unsigned fast_div(unsigned n, FastDiv f) {
  return f.d == 1 ? n : __umulhi(n, f.m) >> f.s;
}

// Division by a constant when a kernel's geometry is fixed at compile time
// (D > 0), else by multiply-high.
template <int D>
__device__ __forceinline__ unsigned divide(unsigned n, const FastDiv& f) {
  if constexpr (D > 0) {
    return n / static_cast<unsigned>(D);
  } else {
    return fast_div(n, f);
  }
}
