"""The VertexCM family's flags (the port's ``render._VCM_FLAGS``)."""

# VertexCM family flags: (use_vc, use_vm, light_trace_only, ppm)
# (vertexcm.hxx:222-244).
_VCM_FLAGS = {
    "lt": (False, False, True, False),
    "ppm": (False, True, False, True),
    "bpm": (False, True, False, False),
    "bpt": (True, False, False, False),
    "vcm": (True, True, False, False),
}
