/* C API implementation for the PyTorch/CUDA port: embeds a CPython
 * interpreter running thallo_tpu_torch (the counterpart of
 * capi/src/thallo_capi.cpp, which runs the JAX package).
 *
 * The analog of the reference's createwrapper.t, which boots an embedded
 * LuaJIT+Terra state inside Thallo_NewState and dispatches the 13 API
 * functions into it (API/src/createwrapper.t:130-223).  Here the state is
 * the CPython interpreter + the thallo_tpu_torch.capi_bridge module;
 * problems/plans are integer handles into bridge-side registries.  Plans
 * run on the GPU unless cpuOnly is set; without CUDA, Thallo_ProblemPlan
 * prints the Python error and returns NULL (no fallback to the CPU).
 */
#include "ThalloTPU.h"

#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct StateImpl {
    PyObject* bridge = nullptr;  // thallo_tpu_torch.capi_bridge module
    long handle = 0;
    int verbosity = 0;
};

struct ProblemImpl {
    long handle;
};
struct PlanImpl {
    long handle;
    int n_params;  // number of void** entries expected
};

bool g_python_initialized = false;

void report_py_error(const char* where) {
    std::fprintf(stderr, "[thallo_tpu_torch] python error in %s:\n", where);
    PyErr_Print();
}

PyObject* call_bridge(StateImpl* st, const char* fn, PyObject* args) {
    PyObject* f = PyObject_GetAttrString(st->bridge, fn);
    if (!f) {
        report_py_error(fn);
        return nullptr;
    }
    PyObject* r = PyObject_CallObject(f, args);
    Py_DECREF(f);
    Py_XDECREF(args);
    if (!r) report_py_error(fn);
    return r;
}

}  // namespace

extern "C" {

Thallo_State* Thallo_NewState(Thallo_InitializationParameters params) {
    if (!g_python_initialized) {
        Py_InitializeEx(0);
        g_python_initialized = true;
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* mod = PyImport_ImportModule("thallo_tpu_torch.capi_bridge");
    if (!mod) {
        report_py_error("import thallo_tpu_torch.capi_bridge (is thallo_tpu_torch on PYTHONPATH?)");
        PyGILState_Release(gil);
        return nullptr;
    }
    StateImpl* st = new StateImpl();
    st->bridge = mod;
    st->verbosity = params.verbosityLevel;
    PyObject* r = call_bridge(
        st, "new_state",
        Py_BuildValue("(iiiii)", params.doublePrecision, params.verbosityLevel,
                      params.timingLevel, params.useAutoscheduler, params.cpuOnly));
    if (!r) {
        delete st;
        PyGILState_Release(gil);
        return nullptr;
    }
    st->handle = PyLong_AsLong(r);
    Py_DECREF(r);
    PyGILState_Release(gil);
    return reinterpret_cast<Thallo_State*>(st);
}

Thallo_Problem* Thallo_ProblemDefine(Thallo_State* state, const char* filename,
                                     const char* solverkind) {
    StateImpl* st = reinterpret_cast<StateImpl*>(state);
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call_bridge(st, "problem_define",
                              Py_BuildValue("(lss)", st->handle, filename, solverkind));
    Thallo_Problem* out = nullptr;
    if (r) {
        ProblemImpl* p = new ProblemImpl{PyLong_AsLong(r)};
        Py_DECREF(r);
        out = reinterpret_cast<Thallo_Problem*>(p);
    }
    PyGILState_Release(gil);
    return out;
}

void Thallo_ProblemDelete(Thallo_State* state, Thallo_Problem* problem) {
    if (!problem) return;
    StateImpl* st = reinterpret_cast<StateImpl*>(state);
    ProblemImpl* p = reinterpret_cast<ProblemImpl*>(problem);
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call_bridge(st, "problem_delete", Py_BuildValue("(l)", p->handle));
    Py_XDECREF(r);
    PyGILState_Release(gil);
    delete p;
}

Thallo_Plan* Thallo_ProblemPlan(Thallo_State* state, Thallo_Problem* problem,
                                unsigned int* dimensions) {
    StateImpl* st = reinterpret_cast<StateImpl*>(state);
    ProblemImpl* p = reinterpret_cast<ProblemImpl*>(problem);
    PyGILState_STATE gil = PyGILState_Ensure();
    /* ask the bridge how many dims the energy declares */
    PyObject* nd =
        call_bridge(st, "problem_num_dims", Py_BuildValue("(l)", p->handle));
    if (!nd) {
        PyGILState_Release(gil);
        return nullptr;
    }
    long n = PyLong_AsLong(nd);
    Py_DECREF(nd);
    PyObject* dims = PyList_New(n);
    for (long i = 0; i < n; i++)
        PyList_SetItem(dims, i, PyLong_FromUnsignedLong(dimensions[i]));
    PyObject* r = call_bridge(st, "problem_plan",
                              Py_BuildValue("(llN)", st->handle, p->handle, dims));
    Thallo_Plan* out = nullptr;
    if (r) {
        long h = PyLong_AsLong(r);
        Py_DECREF(r);
        PyObject* np_ = call_bridge(st, "plan_num_params", Py_BuildValue("(l)", h));
        int nparams = np_ ? (int)PyLong_AsLong(np_) : 0;
        Py_XDECREF(np_);
        PlanImpl* pl = new PlanImpl{h, nparams};
        out = reinterpret_cast<Thallo_Plan*>(pl);
    }
    PyGILState_Release(gil);
    return out;
}

void Thallo_PlanFree(Thallo_State* state, Thallo_Plan* plan) {
    if (!plan) return;
    StateImpl* st = reinterpret_cast<StateImpl*>(state);
    PlanImpl* pl = reinterpret_cast<PlanImpl*>(plan);
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call_bridge(st, "plan_free", Py_BuildValue("(l)", pl->handle));
    Py_XDECREF(r);
    PyGILState_Release(gil);
    delete pl;
}

void Thallo_SetSolverParameter(Thallo_State* state, Thallo_Plan* plan,
                               const char* name, void* value) {
    StateImpl* st = reinterpret_cast<StateImpl*>(state);
    PlanImpl* pl = reinterpret_cast<PlanImpl*>(plan);
    /* iteration counts arrive as int*, everything else as float/double*
     * (matching the reference's SolverParameters struct field types,
     * gauss_newton.t:200-216) */
    double v;
    if (!strcmp(name, "nIterations") || !strcmp(name, "lIterations") ||
        !strcmp(name, "residual_reset_period")) {
        v = (double)*reinterpret_cast<int*>(value);
    } else {
        v = (double)*reinterpret_cast<float*>(value);
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call_bridge(st, "set_solver_parameter",
                              Py_BuildValue("(lsd)", pl->handle, name, v));
    Py_XDECREF(r);
    PyGILState_Release(gil);
}

void Thallo_GetSolverParameter(Thallo_State* state, Thallo_Plan* plan,
                               const char* name, void* value) {
    StateImpl* st = reinterpret_cast<StateImpl*>(state);
    PlanImpl* pl = reinterpret_cast<PlanImpl*>(plan);
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call_bridge(st, "get_solver_parameter",
                              Py_BuildValue("(ls)", pl->handle, name));
    if (r) {
        double v = PyFloat_AsDouble(r);
        Py_DECREF(r);
        if (!strcmp(name, "nIterations") || !strcmp(name, "lIterations") ||
            !strcmp(name, "residual_reset_period")) {
            *reinterpret_cast<int*>(value) = (int)v;
        } else {
            *reinterpret_cast<float*>(value) = (float)v;
        }
    }
    PyGILState_Release(gil);
}

namespace {
PyObject* ptr_list(PlanImpl* pl, void** problemparams) {
    PyObject* lst = PyList_New(pl->n_params);
    for (int i = 0; i < pl->n_params; i++)
        PyList_SetItem(lst, i, PyLong_FromVoidPtr(problemparams[i]));
    return lst;
}
}  // namespace

void Thallo_ProblemSolve(Thallo_State* state, Thallo_Plan* plan, void** problemparams) {
    StateImpl* st = reinterpret_cast<StateImpl*>(state);
    PlanImpl* pl = reinterpret_cast<PlanImpl*>(plan);
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call_bridge(
        st, "problem_solve", Py_BuildValue("(lN)", pl->handle, ptr_list(pl, problemparams)));
    Py_XDECREF(r);
    PyGILState_Release(gil);
}

void Thallo_ProblemInit(Thallo_State* state, Thallo_Plan* plan, void** problemparams) {
    StateImpl* st = reinterpret_cast<StateImpl*>(state);
    PlanImpl* pl = reinterpret_cast<PlanImpl*>(plan);
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call_bridge(
        st, "problem_init", Py_BuildValue("(lN)", pl->handle, ptr_list(pl, problemparams)));
    Py_XDECREF(r);
    PyGILState_Release(gil);
}

int Thallo_ProblemStep(Thallo_State* state, Thallo_Plan* plan, void** problemparams) {
    StateImpl* st = reinterpret_cast<StateImpl*>(state);
    PlanImpl* pl = reinterpret_cast<PlanImpl*>(plan);
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call_bridge(
        st, "problem_step", Py_BuildValue("(lN)", pl->handle, ptr_list(pl, problemparams)));
    int cont = 0;
    if (r) {
        cont = (int)PyLong_AsLong(r);
        Py_DECREF(r);
    }
    PyGILState_Release(gil);
    return cont;
}

double Thallo_ProblemCurrentCost(Thallo_State* state, Thallo_Plan* plan) {
    StateImpl* st = reinterpret_cast<StateImpl*>(state);
    PlanImpl* pl = reinterpret_cast<PlanImpl*>(plan);
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call_bridge(st, "current_cost", Py_BuildValue("(l)", pl->handle));
    double c = 0.0;
    if (r) {
        c = PyFloat_AsDouble(r);
        Py_DECREF(r);
    }
    PyGILState_Release(gil);
    return c;
}

void Thallo_GetPerformanceSummary(Thallo_State* state, Thallo_Plan* plan,
                                  Thallo_PerformanceSummary* summary) {
    StateImpl* st = reinterpret_cast<StateImpl*>(state);
    PlanImpl* pl = reinterpret_cast<PlanImpl*>(plan);
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call_bridge(st, "performance_summary", Py_BuildValue("(l)", pl->handle));
    if (r && PyList_Check(r) && PyList_Size(r) == 25) {
        Thallo_PerformanceEntry* entries[5] = {
            &summary->total, &summary->nonlinearIteration, &summary->nonlinearSetup,
            &summary->linearSolve, &summary->nonlinearResolve};
        for (int e = 0; e < 5; e++) {
            entries[e]->count = (unsigned)PyFloat_AsDouble(PyList_GetItem(r, e * 5));
            entries[e]->minMS = PyFloat_AsDouble(PyList_GetItem(r, e * 5 + 1));
            entries[e]->maxMS = PyFloat_AsDouble(PyList_GetItem(r, e * 5 + 2));
            entries[e]->meanMS = PyFloat_AsDouble(PyList_GetItem(r, e * 5 + 3));
            entries[e]->stddevMS = PyFloat_AsDouble(PyList_GetItem(r, e * 5 + 4));
        }
    }
    Py_XDECREF(r);
    PyGILState_Release(gil);
}

}  // extern "C"
