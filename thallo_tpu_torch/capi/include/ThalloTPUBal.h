// BAL ("Bundle Adjustment in the Large") problem loader for the C++
// application layer — the native-side analog of the reference examples'
// data loading (examples/bundle_adjustment main.cpp reads BAL text
// problems; examples/shared/* load meshes/images).  Header-only.
#pragma once

#include <cstdio>
#include <stdexcept>
#include <string>
#include <vector>

namespace thallo_tpu {

struct BalProblem {
    int num_cameras = 0;
    int num_points = 0;
    int num_observations = 0;
    std::vector<int> camera_index;    // [O]
    std::vector<int> point_index;     // [O]
    std::vector<float> observations;  // [O*2]
    std::vector<float> cameras;       // [C*9] Snavely: angle-axis, t, f, k1, k2
    std::vector<float> points;        // [P*3]
};

inline BalProblem LoadBal(const std::string& path) {
    FILE* f = std::fopen(path.c_str(), "r");
    if (!f) throw std::runtime_error("cannot open BAL file: " + path);
    BalProblem p;
    if (std::fscanf(f, "%d %d %d", &p.num_cameras, &p.num_points,
                    &p.num_observations) != 3) {
        std::fclose(f);
        throw std::runtime_error("bad BAL header: " + path);
    }
    p.camera_index.resize(p.num_observations);
    p.point_index.resize(p.num_observations);
    p.observations.resize(2 * (size_t)p.num_observations);
    for (int i = 0; i < p.num_observations; ++i) {
        double x, y;
        if (std::fscanf(f, "%d %d %lf %lf", &p.camera_index[i], &p.point_index[i],
                        &x, &y) != 4) {
            std::fclose(f);
            throw std::runtime_error("bad BAL observation line");
        }
        p.observations[2 * i] = (float)x;
        p.observations[2 * i + 1] = (float)y;
    }
    p.cameras.resize(9 * (size_t)p.num_cameras);
    for (auto& v : p.cameras) {
        double d;
        if (std::fscanf(f, "%lf", &d) != 1) { std::fclose(f); throw std::runtime_error("bad BAL camera"); }
        v = (float)d;
    }
    p.points.resize(3 * (size_t)p.num_points);
    for (auto& v : p.points) {
        double d;
        if (std::fscanf(f, "%lf", &d) != 1) { std::fclose(f); throw std::runtime_error("bad BAL point"); }
        v = (float)d;
    }
    std::fclose(f);
    return p;
}

}  // namespace thallo_tpu
