/* ThalloTPU.h — C API for the NLLS framework (the PyTorch/CUDA port's copy).
 *
 * Mirrors the 13-function surface of the reference C API
 * (API/release/include/Thallo.h:41-106) so existing C/C++ applications
 * port with a header swap.  This copy belongs to the PyTorch/CUDA port:
 * the implementation embeds a CPython interpreter running thallo_tpu_torch
 * (the analog of the reference's embedded LuaJIT+Terra state,
 * createwrapper.t:130-223); plans run on the GPU unless cpuOnly is set.
 *
 * Data convention: problem parameters are passed as a void** ordered by
 * each input's declared argument position in the energy file.  Image /
 * unknown entries point at HOST float32 (or float64 when doublePrecision)
 * arrays laid out as [dim0, dim1, ..., channels] row-major; Sparse entries
 * point at int32 index arrays.  Unknowns are copied back to their host
 * buffers after each solve/step.
 */
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

typedef struct Thallo_State Thallo_State;
typedef struct Thallo_Plan Thallo_Plan;
typedef struct Thallo_Problem Thallo_Problem;

struct Thallo_InitializationParameters {
    /* nonzero: all values double precision (the f64 kernels on the GPU) */
    int doublePrecision;
    /* 0: quiet, 1: verbose */
    int verbosityLevel;
    /* 0: none, 1: coarse phases, 2: per-phase stats, 3: invasive (block
       after every step) */
    int timingLevel;
    /* unused (each kernel picks its own blocks); kept for source compatibility */
    int threadsPerBlock;
    /* nonzero: override manual schedules with the autoscheduler */
    int useAutoscheduler;
    /* nonzero: run on the CPU (plain torch versions of the kernels); zero:
       on the GPU, and Thallo_ProblemPlan returns NULL without CUDA */
    int cpuOnly;
};
typedef struct Thallo_InitializationParameters Thallo_InitializationParameters;

Thallo_State* Thallo_NewState(Thallo_InitializationParameters params);

/* Load a problem specification (a thallo_tpu Python energy file) and pick
 * a solver kind: "gauss_newton" or "levenberg_marquardt" (alias "LM"). */
Thallo_Problem* Thallo_ProblemDefine(Thallo_State* state, const char* filename,
                                     const char* solverkind);
void Thallo_ProblemDelete(Thallo_State* state, Thallo_Problem* problem);

/* Bind dimension sizes (ordered as declared by Dims(...)) and compile. */
Thallo_Plan* Thallo_ProblemPlan(Thallo_State* state, Thallo_Problem* problem,
                                unsigned int* dimensions);
void Thallo_PlanFree(Thallo_State* state, Thallo_Plan* plan);

/* value points at a double (all numeric parameters) or int for the
 * iteration counts, matching the reference's string-keyed parameters
 * (gauss_newton.t:1828-1862). */
void Thallo_SetSolverParameter(Thallo_State* state, Thallo_Plan* plan,
                               const char* name, void* value);
void Thallo_GetSolverParameter(Thallo_State* state, Thallo_Plan* plan,
                               const char* name, void* value);

void Thallo_ProblemSolve(Thallo_State* state, Thallo_Plan* plan,
                         void** problemparams);
void Thallo_ProblemInit(Thallo_State* state, Thallo_Plan* plan,
                        void** problemparams);
/* returns 0 when the solver is finished */
int Thallo_ProblemStep(Thallo_State* state, Thallo_Plan* plan,
                       void** problemparams);

double Thallo_ProblemCurrentCost(Thallo_State* state, Thallo_Plan* plan);

struct Thallo_PerformanceEntry {
    unsigned int count;
    double minMS;
    double maxMS;
    double meanMS;
    double stddevMS;
};
typedef struct Thallo_PerformanceEntry Thallo_PerformanceEntry;

struct Thallo_PerformanceSummary {
    Thallo_PerformanceEntry total;
    Thallo_PerformanceEntry nonlinearIteration;
    Thallo_PerformanceEntry nonlinearSetup;
    Thallo_PerformanceEntry linearSolve;
    Thallo_PerformanceEntry nonlinearResolve;
};
typedef struct Thallo_PerformanceSummary Thallo_PerformanceSummary;

void Thallo_GetPerformanceSummary(Thallo_State* state, Thallo_Plan* plan,
                                  Thallo_PerformanceSummary* summary);

#ifdef __cplusplus
}
#endif
