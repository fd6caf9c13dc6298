// Concurrency stress main for the batched env engine (the port's own copy of
// the JAX package's native/engine_stress_test.cpp) — built with
// -fsanitize=thread by `python -m deep_neuroevolution_torch.native.build --stress`
// (the TSAN-in-CI discipline SURVEY §5.2 prescribes for the host engine;
// the reference had no sanitizer coverage at all).
#include "env_engine.h"

#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

int main() {
  const int B = 32;
  void* h = nevo_create("toy", "", B, 4);
  if (!h) {
    std::fprintf(stderr, "create failed\n");
    return 1;
  }
  std::vector<int> idx(B), noops(B, 3), mf(B, 4000);
  for (int i = 0; i < B; ++i) idx[i] = i;
  nevo_reset(h, idx.data(), noops.data(), mf.data(), B);

  std::vector<int> actions(B, 1);
  std::vector<float> rew(B);
  std::vector<uint8_t> done(B);
  std::vector<uint8_t> obs((size_t)B * 2 * 210 * 160);
  std::vector<float> fs((size_t)B * 128);

  for (int iter = 0; iter < 300; ++iter) {
    for (int i = 0; i < B; ++i) actions[i] = iter % 4;
    nevo_step(h, idx.data(), actions.data(), B, rew.data(), done.data());
    nevo_observe(h, idx.data(), B, obs.data());
    nevo_final_state(h, idx.data(), B, fs.data());
    // randomly reset a few finished slots, exercising concurrent reset paths
    std::vector<int> resets;
    for (int i = 0; i < B; ++i)
      if (done[i]) resets.push_back(i);
    if (!resets.empty()) {
      std::vector<int> n2(resets.size(), 5), m2(resets.size(), 4000);
      nevo_reset(h, resets.data(), n2.data(), m2.data(), (int)resets.size());
    }
  }
  nevo_destroy(h);
  std::printf("stress ok\n");
  return 0;
}
