/* C smoke test for the C API: the reference's tests/minimal mini-app
 * (tests/minimal/main.cpp) against the PyTorch port —
 * 2-D laplacian denoise, prints the final cost. */
#include <stdio.h>
#include <stdlib.h>

#include "ThalloTPU.h"

int main(void) {
    const unsigned int dim = 32;
    float* target = (float*)malloc(dim * dim * sizeof(float));
    float* unknown = (float*)malloc(dim * dim * sizeof(float));
    for (unsigned i = 0; i < dim * dim; ++i) {
        target[i] = (float)rand() / (float)RAND_MAX;
        unknown[i] = target[i];
    }

    Thallo_InitializationParameters param = {0};
    param.verbosityLevel = 1;
    param.timingLevel = 2; /* invasive: per-phase stats (reference Thallo.h:19-25) */
    param.cpuOnly = 1;     /* smoke test runs on the CPU backend */
    Thallo_State* state = Thallo_NewState(param);
    if (!state) return 2;

    Thallo_Problem* problem =
        Thallo_ProblemDefine(state, "test/laplacian_energy.py", "gauss_newton");
    if (!problem) return 3;

    unsigned int dims[] = {dim, dim};
    Thallo_Plan* plan = Thallo_ProblemPlan(state, problem, dims);
    if (!plan) return 4;

    int nIter = 8, lIter = 20;
    Thallo_SetSolverParameter(state, plan, "nIterations", &nIter);
    Thallo_SetSolverParameter(state, plan, "lIterations", &lIter);

    void* problem_data[] = {unknown, target};
    Thallo_ProblemSolve(state, plan, problem_data);
    double cost = Thallo_ProblemCurrentCost(state, plan);

    Thallo_PerformanceSummary summary;
    Thallo_GetPerformanceSummary(state, plan, &summary);
    printf("total solve: count=%u mean=%.2fms\n", summary.total.count,
           summary.total.meanMS);
    printf("phases: setup=%u linear=%u finish=%u\n", summary.nonlinearSetup.count,
           summary.linearSolve.count, summary.nonlinearResolve.count);
    /* at timingLevel>=2 every phase must carry real measurements
     * (reference util.t:537-541 fills all five by name) */
    if (summary.linearSolve.count == 0 || summary.linearSolve.meanMS <= 0.0 ||
        summary.nonlinearResolve.count == 0 || summary.nonlinearSetup.count == 0) {
        printf("FAIL (missing phase stats)\n");
        return 1;
    }

    /* the solver must have smoothed the unknown away from the target */
    double drift = 0.0;
    for (unsigned i = 0; i < dim * dim; ++i) drift += (unknown[i] - target[i]) * (unknown[i] - target[i]);

    Thallo_PlanFree(state, plan);
    Thallo_ProblemDelete(state, problem);

    printf("\nminimal %g (unknown drift %g)\n", cost, drift);
    if (cost <= 0.0 || drift <= 0.0) {
        printf("FAIL\n");
        return 1;
    }
    printf("PASS\n");
    return 0;
}
