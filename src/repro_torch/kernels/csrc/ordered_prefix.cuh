// An in-order prefix sum that rounds as XLA's CPU code rounds jnp.cumsum:
// in-order sums within blocks of 16, plus the inclusive sum of the blocks
// before, itself taken by the same rule over the block totals (in-order
// within groups of 16 totals, plus the groups before, in order); exact for
// up to 16 * 16 * 16 = 4096 terms.  The plain versions of the scans sum
// their log decays so (core/ordered.py ordered_cumsum), as the reference
// does, so a kernel that feeds the terms in order through add() gives the
// plain version's prefix bit for bit.
#pragma once

namespace ordered {

struct Prefix {
  float run = 0.f;    // this block's terms so far
  float group = 0.f;  // this group's block totals so far
  float groups = 0.f; // the totals of the groups before, in order
  float base = 0.f;   // the blocks before this one, in XLA's order
  int i = 0;

  // Adds the next term; returns the prefix sum through it.
  __device__ __forceinline__ float add(float x) {
    if (i > 0 && i % 16 == 0) {
      const int b = i / 16 - 1;  // the block just closed
      if (b % 16 == 0) {
        if (b > 0) groups = b == 16 ? group : groups + group;
        group = run;
      } else {
        group += run;
      }
      base = b < 16 ? group : group + groups;
      run = 0.f;
    }
    run += x;
    ++i;
    return i <= 16 ? run : run + base;
  }
};

}  // namespace ordered
