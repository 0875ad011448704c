// End-to-end C++ bundle adjustment from a BAL file: LoadBal ->
// NamedParameters (graphs as int32 index arrays) -> LM solve through the
// C API (the reference's examples/bundle_adjustment data flow,
// CombinedSolverBase.h:102-155).
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "ThalloTPUBal.h"
#include "ThalloTPUSolver.h"

// write a tiny synthetic BAL problem: cameras on a line looking at a
// point cloud, observations from the Snavely model with noisy guesses
static std::string WriteSyntheticBal(int n_cams, int n_pts) {
    const char* tmp = std::getenv("TMPDIR");
    std::string path = std::string(tmp && *tmp ? tmp : "/tmp") + "/test_problem.bal";
    FILE* f = std::fopen(path.c_str(), "w");
    int obs_per_pt = 2;
    std::fprintf(f, "%d %d %d\n", n_cams, n_pts, n_pts * obs_per_pt);
    std::vector<double> pts(3 * n_pts), cams(9 * n_cams, 0.0);
    srand(7);
    auto frand = [] { return 2.0 * rand() / RAND_MAX - 1.0; };
    for (int j = 0; j < n_pts; ++j) {
        pts[3 * j] = frand();
        pts[3 * j + 1] = frand();
        pts[3 * j + 2] = 6.0 + frand();
    }
    for (int c = 0; c < n_cams; ++c) {
        cams[9 * c + 3] = 0.4 * c;  // translation x
        cams[9 * c + 6] = 500.0;    // focal
        cams[9 * c + 7] = 1e-7;
        cams[9 * c + 8] = 1e-13;
    }
    for (int j = 0; j < n_pts; ++j) {
        for (int k = 0; k < obs_per_pt; ++k) {
            int c = (j + k) % n_cams;
            // project (rotation is identity in the synthetic setup)
            double px = pts[3 * j] + cams[9 * c + 3];
            double py = pts[3 * j + 1] + cams[9 * c + 4];
            double pz = pts[3 * j + 2] + cams[9 * c + 5];
            double cx = -px / pz, cy = -py / pz;
            double r2 = cx * cx + cy * cy;
            double d = 1.0 + r2 * (cams[9 * c + 7] + cams[9 * c + 8] * r2);
            std::fprintf(f, "%d %d %.10g %.10g\n", c, j,
                         cx * cams[9 * c + 6] * d, cy * cams[9 * c + 6] * d);
        }
    }
    for (int c = 0; c < n_cams; ++c)
        for (int k = 0; k < 9; ++k)
            std::fprintf(f, "%.10g\n", cams[9 * c + k] + (k < 6 ? 1e-3 * frand() : 0.0));
    for (int j = 0; j < n_pts; ++j)
        for (int k = 0; k < 3; ++k)
            std::fprintf(f, "%.10g\n", pts[3 * j + k] + 5e-2 * frand());
    std::fclose(f);
    return path;
}

int main() {
    auto path = WriteSyntheticBal(3, 48);
    auto bal = thallo_tpu::LoadBal(path);
    std::printf("BAL: %d cams %d pts %d obs\n", bal.num_cameras, bal.num_points,
                bal.num_observations);

    Thallo_InitializationParameters ip{};
    ip.cpuOnly = 1;
    ip.timingLevel = 1;
    thallo_tpu::Solver solver(
        "test/ba_energy.py", "levenberg_marquardt",
        {(unsigned)bal.num_cameras, (unsigned)bal.num_points,
         (unsigned)bal.num_observations},
        ip);
    solver.set_parameter("nIterations", 12);
    solver.set_parameter("lIterations", 20);

    thallo_tpu::NamedParameters params;
    params.set("cameras", bal.cameras.data());
    params.set("points", bal.points.data());
    params.set("observations", bal.observations.data());
    params.set("oToC", bal.camera_index.data());
    params.set("oToP", bal.point_index.data());

    double c0 = 0, cF = 0;
    solver.init(params);
    c0 = solver.current_cost();
    solver.solve(params);
    cF = solver.current_cost();
    std::printf("\nbal_solve %g -> %g\n", c0, cF);
    if (!(cF < 0.05 * c0) || !std::isfinite(cF)) {
        std::printf("FAIL\n");
        return 1;
    }
    printf("PASS\n");
    return 0;
}
