// Bundle adjustment of a BAL file through the C API, step by step: the
// data flow of the reference's examples/bundle_adjustment (LoadBal ->
// NamedParameters -> Thallo_ProblemInit, then Thallo_ProblemStep).
//
//   bal_solve [--gpu] [--energy ENERGY.py] BAL_PATH N_STEPS L_ITERS OUT_PATH
//
// prints the initial cost and each step's cost, then writes the solved
// cameras [C, 9] and points [P, 3] as raw little-endian float32 to
// OUT_PATH.  Without --gpu the plan runs on the CPU (cpuOnly); with it on
// the GPU, and the plan fails without CUDA.  ENERGY.py defaults to
// test/ba_energy.py (relative to the working directory).
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "ThalloTPUBal.h"
#include "ThalloTPUSolver.h"

int main(int argc, char** argv) {
    bool gpu = false;
    std::string energy = "test/ba_energy.py";
    std::vector<const char*> pos;
    for (int i = 1; i < argc; ++i) {
        if (!std::strcmp(argv[i], "--gpu")) {
            gpu = true;
        } else if (!std::strcmp(argv[i], "--energy") && i + 1 < argc) {
            energy = argv[++i];
        } else {
            pos.push_back(argv[i]);
        }
    }
    if (pos.size() != 4) {
        std::fprintf(stderr,
                     "usage: %s [--gpu] [--energy ENERGY.py] BAL_PATH N_STEPS L_ITERS OUT_PATH\n",
                     argv[0]);
        return 2;
    }
    const int n_steps = std::atoi(pos[1]), l_iters = std::atoi(pos[2]);
    auto bal = thallo_tpu::LoadBal(pos[0]);
    std::printf("BAL: %d cams %d pts %d obs\n", bal.num_cameras, bal.num_points,
                bal.num_observations);

    Thallo_InitializationParameters ip{};
    ip.cpuOnly = gpu ? 0 : 1;
    ip.timingLevel = 1;
    try {
        thallo_tpu::Solver solver(energy, "levenberg_marquardt",
                                  {(unsigned)bal.num_cameras, (unsigned)bal.num_points,
                                   (unsigned)bal.num_observations},
                                  ip);
        solver.set_parameter("nIterations", n_steps);
        solver.set_parameter("lIterations", l_iters);
        thallo_tpu::NamedParameters params;
        params.set("cameras", bal.cameras.data());
        params.set("points", bal.points.data());
        params.set("observations", bal.observations.data());
        params.set("oToC", bal.camera_index.data());
        params.set("oToP", bal.point_index.data());
        solver.init(params);
        std::printf("cost 0 %.9g\n", solver.current_cost());
        for (int k = 1; k <= n_steps; ++k) {
            solver.step(params);
            std::printf("cost %d %.9g\n", k, solver.current_cost());
        }
    } catch (const std::exception& e) {
        std::fprintf(stderr, "FAIL: %s\n", e.what());
        return 1;
    }
    FILE* f = std::fopen(pos[3], "wb");
    if (!f) {
        std::fprintf(stderr, "FAIL: cannot write %s\n", pos[3]);
        return 1;
    }
    std::fwrite(bal.cameras.data(), sizeof(float), bal.cameras.size(), f);
    std::fwrite(bal.points.data(), sizeof(float), bal.points.size(), f);
    std::fclose(f);
    std::printf("wrote %s\n", pos[3]);
    return 0;
}
