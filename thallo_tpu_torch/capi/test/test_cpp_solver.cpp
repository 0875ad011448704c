// C++ harness smoke test: the RAII Solver + NamedParameters layer
// (reference examples/shared/ThalloSolver.h usage pattern) driving the
// step-wise API on the laplacian energy.
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "ThalloTPUSolver.h"

int main() {
  const unsigned dim = 24;
  std::vector<float> target(dim * dim), unknown(dim * dim);
  for (auto i = 0u; i < dim * dim; ++i) {
    target[i] = (float)rand() / (float)RAND_MAX;
    unknown[i] = target[i];
  }

  Thallo_InitializationParameters p{};
  p.cpuOnly = 1;
  thallo_tpu::Solver solver("test/laplacian_energy.py", "levenberg_marquardt",
                            {dim, dim}, p);
  solver.set_parameter("nIterations", 6);
  solver.set_parameter("lIterations", 15);

  thallo_tpu::NamedParameters params;
  params.set("X", unknown.data());
  params.set("A", target.data());

  // step-wise outer loop (Thallo_ProblemInit / Step re-entrancy)
  solver.init(params);
  int steps = 0;
  while (solver.step(params)) steps++;
  double cost = solver.current_cost();
  auto perf = solver.performance_summary();
  std::printf("cpp solver: cost=%g after %d steps, nonlinear mean=%.2fms\n",
              cost, steps, perf.nonlinearIteration.meanMS);
  if (cost <= 0.0 || steps < 1) {
    std::printf("FAIL\n");
    return 1;
  }
  std::printf("PASS\n");
  return 0;
}
