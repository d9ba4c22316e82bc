"""The bound arithmetic against the figures the program's own smoke run
printed at the flagship (274,003 active segments, 100 channels, 4 gases,
one window, 224 u points)."""
from h100bench import roofline

FLAGSHIP = dict(n_active=274003, D=100, G=4, W=1, K=224)


def test_fused_ops_match_the_flagship_figures():
    assert round(roofline.fused_ops("turbo", **FLAGSHIP) / 1e9, 2) == 54.80
    assert round(roofline.fused_ops("table", **FLAGSHIP) / 1e9, 2) == 25.43


def test_turbo_bound_is_operations():
    s, by, n_bytes, ops = roofline.turbo(274003, 1084, 400, 4, 1, 100, 40,
                                         30, 224, 1201)
    assert by == "operations" and abs(s - 54.80e9 / 67e12) < 1e-5
    assert n_bytes < ops / 67e12 * 3.35e12


def test_rt_exact_scales_with_channels():
    a = roofline.rt_exact(274003, 1084, 400, 4, 1, 100, 40, 30, 224, 1201, 8)
    b = roofline.rt_exact(274003, 1084, 400, 4, 1, 512, 40, 30, 224, 1201, 8)
    assert a[1] == b[1] == "operations"
    assert abs(b[3] / a[3] - 5.12) < 1e-12
    # 24 + 2 x 8 operations a corner: 880 a segment and channel
    assert b[3] == 274003 * 512 * 880


def test_jacobian_parts():
    parts = roofline.jacobian_exact(274003, 1084, 400, 46, 46, 130, 4, 1,
                                    512, 40, 30, 224, 1201, 8)
    assert set(parts) == {"tracer", "tracer tangents", "RT record",
                          "contraction"}
    assert all(v[0] > 0 for v in parts.values())
    # the contraction: 2 operations per (segment, channel, field, tangent)
    assert parts["contraction"][3] == (2 * 274003 * 12 * 512 * 130
                                       + 2 * 1084 * 512 * 130)
