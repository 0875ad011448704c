# Snavely bundle adjustment energy for the C API (port of
# the reference's examples/bundle_adjustment/bundle_adjustment.t)
C, P, O = Dims("C", "P", "O")
Inputs(
    cameras=Unknown(float9, (C,), 0),
    points=Unknown(float3, (P,), 1),
    observations=Array(float2, (O,), 2),
    oToC=Sparse((O,), (C,), 3),
    oToP=Sparse((O,), (P,), 4),
)
UsePreconditioner(True)
o = O()
camera, point = cameras(oToC(o)), points(oToP(o))
p = AngleAxisRotatePoint(camera.slice(0, 3), point)
p = p + camera.slice(3, 6)
center_of_distortion = Vector(-p(0) / p(2), -p(1) / p(2))
l1 = camera(7)
l2 = camera(8)
r2 = dot(center_of_distortion, center_of_distortion)
distortion = 1.0 + r2 * (l1 + l2 * r2)
focal = camera(6)
predicted = center_of_distortion * focal * distortion
observed = observations(o)
r = Residuals(snavely_reprojection_error=observed - predicted)
