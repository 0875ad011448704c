/* Header-only C++ convenience layer over the C API.
 *
 * The analog of the reference's application harness
 * (examples/shared/ThalloSolver.h:40-113 RAII wrapper,
 * NamedParameters.h ordered name->pointer map, ThalloGraph.h:19-60
 * hyper-edge arrays): construct a solver from an energy file, bind
 * host arrays by name in declaration order, solve, read back unknowns.
 */
#pragma once

#include <cstdint>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

#include "ThalloTPU.h"

namespace thallo_tpu {

/* Ordered name -> pointer map; .data() yields the void** in argument
 * order for Thallo_ProblemSolve (reference NamedParameters.h). */
class NamedParameters {
 public:
  void set(const std::string& name, void* ptr) {
    for (auto& kv : entries_)
      if (kv.first == name) {
        kv.second = ptr;
        return;
      }
    entries_.emplace_back(name, ptr);
  }
  std::vector<void*> data() const {
    std::vector<void*> out;
    out.reserve(entries_.size());
    for (auto& kv : entries_) out.push_back(kv.second);
    return out;
  }
  size_t size() const { return entries_.size(); }

 private:
  std::vector<std::pair<std::string, void*>> entries_;
};

/* RAII solver (reference ThalloSolver.h): NewState -> ProblemDefine ->
 * ProblemPlan in the constructor; solve() runs to completion. */
class Solver {
 public:
  Solver(const std::string& energy_file, const std::string& solver_kind,
         const std::vector<unsigned int>& dims,
         Thallo_InitializationParameters params = {}) {
    state_ = Thallo_NewState(params);
    if (!state_) throw std::runtime_error("Thallo_NewState failed");
    problem_ = Thallo_ProblemDefine(state_, energy_file.c_str(), solver_kind.c_str());
    if (!problem_) throw std::runtime_error("ProblemDefine failed: " + energy_file);
    std::vector<unsigned int> d(dims);
    plan_ = Thallo_ProblemPlan(state_, problem_, d.data());
    if (!plan_) throw std::runtime_error("ProblemPlan failed");
  }
  ~Solver() {
    if (plan_) Thallo_PlanFree(state_, plan_);
    if (problem_) Thallo_ProblemDelete(state_, problem_);
  }
  Solver(const Solver&) = delete;
  Solver& operator=(const Solver&) = delete;

  void set_parameter(const char* name, int v) {
    Thallo_SetSolverParameter(state_, plan_, name, &v);
  }
  void set_parameter(const char* name, float v) {
    Thallo_SetSolverParameter(state_, plan_, name, &v);
  }

  double solve(const NamedParameters& params) {
    auto ptrs = params.data();
    Thallo_ProblemSolve(state_, plan_, ptrs.data());
    return Thallo_ProblemCurrentCost(state_, plan_);
  }

  /* re-entrant outer loop (reference Thallo_ProblemInit/Step usage in
   * bundle_fusion's doubly-nested solver) */
  void init(const NamedParameters& params) {
    auto ptrs = params.data();
    Thallo_ProblemInit(state_, plan_, ptrs.data());
  }
  bool step(const NamedParameters& params) {
    auto ptrs = params.data();
    return Thallo_ProblemStep(state_, plan_, ptrs.data()) != 0;
  }

  double current_cost() { return Thallo_ProblemCurrentCost(state_, plan_); }
  Thallo_PerformanceSummary performance_summary() {
    Thallo_PerformanceSummary s{};
    Thallo_GetPerformanceSummary(state_, plan_, &s);
    return s;
  }

 private:
  Thallo_State* state_ = nullptr;
  Thallo_Problem* problem_ = nullptr;
  Thallo_Plan* plan_ = nullptr;
};

}  // namespace thallo_tpu
