"""chip_smoke.sass_loop, the count of SASS instructions a test in a kernel's
inner loop, on small hand-written `cuobjdump -sass` listings: the counts of
a loop with a warp skip, of a loop like K5's whose tests issue the marker
once more past both votes, and no count (None) where the walk of the
loop's paths stops at its cap or gives a skipping path more instructions
than the full one."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _listing(lines):
    """A `cuobjdump -sass` function from (label or None, instruction)."""
    out, addr = ["\tFunction : _Z6kernelv"], 0
    for label, ins in lines:
        if label is not None:
            out.append(f"{label}:")
        out.append(f"        /*{addr:04x}*/                   {ins} ;")
        addr += 0x10
    return "\n".join(out)


# MUFU.RCP once a test; after the vote, `@!P1 BRA` skips two FADDs.
SKIP = [(None, "MOV R1, c[0x0][0x28]"),
        (".L_x_0", "MUFU.RCP R2, R3"),
        (None, "FMUL R4, R2, R2"),
        (None, "VOTE.ANY R5, PT, P0"),
        (None, "@!P1 BRA `(.L_x_1)"),
        (None, "FADD R6, R4, R4"),
        (None, "FADD R6, R6, R4"),
        (".L_x_1", "@P2 BRA `(.L_x_0)"),
        (None, "EXIT")]

# 13 forward branches in a row: 8,192 paths, above the walk's cap.
MANY = ([(".L_x_0", "MUFU.RCP R2, R3")]
        + [x for b in range(13) for x in (
            (None, f"@P{b % 6} BRA `(.L_x_{b + 1})"),
            (None, "FADD R6, R6, R4"),
            (f".L_x_{b + 1}", "NOP"))]
        + [(None, "@P6 BRA `(.L_x_0)"), (None, "EXIT")])

# The skipping way of the vote's branch is the longer one.
WRONG = [(".L_x_0", "MUFU.RCP R2, R3"),
         (None, "VOTE.ANY R5, PT, P0"),
         (None, "@!P1 BRA `(.L_x_1)"),
         (None, "FADD R6, R4, R4"),
         (None, "BRA `(.L_x_2)"),
         (".L_x_1", "FADD R6, R4, R4"),
         (None, "FADD R6, R6, R4"),
         (None, "FADD R6, R6, R4"),
         (".L_x_2", "@P2 BRA `(.L_x_0)"),
         (None, "EXIT")]


# K5's shape: MUFU.RCP once a test (1/det), a second (the weight's
# division) only past both votes; each vote's `@!P BRA` skips the rest,
# and the division's range check skips its slow path (a CALL).
LIGHT = [(None, "MOV R1, c[0x0][0x28]"),
         (".L_x_0", "MUFU.RCP R2, R3"),
         (None, "FMUL R4, R2, R2"),
         (None, "VOTE.ANY P0, P0"),
         (None, "@!P0 BRA `(.L_x_1)"),
         (None, "FADD R6, R4, R4"),
         (None, "VOTE.ANY P1, P0"),
         (None, "@!P1 BRA `(.L_x_1)"),
         (None, "FMUL R10, R6, R6"),
         (None, "FADD R11, R10, R10"),
         (None, "FADD R12, R11, R10"),
         (None, "MUFU.RCP R7, |R6|"),
         (None, "FCHK P5, R0, |R6|"),
         (None, "@!P5 BRA `(.L_x_2)"),
         (None, "CALL.REL.NOINC `($__internal_fdiv)"),
         (".L_x_2", "FMUL R8, R7, R6"),
         (None, "FADD R9, R9, R8"),
         (".L_x_1", "@P2 BRA `(.L_x_0)"),
         (None, "EXIT")]


@pytest.mark.parametrize("lines, per_full, want", [
    (SKIP, 0, {"tests_per_iteration": 1.0, "per_test_full": 7.0,
               "per_test_mid": None, "per_test_skip": 5.0, "paths": 2}),
    (MANY, 0, None),
    (WRONG, 0, None),
    # counted as K5 is (SASS_MARKERS): every path runs the one test; the
    # votes are followed both ways though the passing way holds a CALL,
    # the division's range check only past its slow path
    (LIGHT, 1, {"tests_per_iteration": 1.0, "per_test_full": 16.0,
                "per_test_mid": 8.0, "per_test_skip": 5.0, "paths": 3}),
    # counted as the sweep is, the full path alone would seem to run two
    # tests and no path would count as a skip
    (LIGHT, 0, {"tests_per_iteration": 2.0, "per_test_full": 8.0,
                "per_test_mid": None, "per_test_skip": None, "paths": 3}),
], ids=["warp_skip", "path_cap", "skip_longer_than_full", "light",
        "light_as_sweep"])
def test_sass_loop(lines, per_full, want):
    cs = _chip_smoke()
    (insns, labels), = cs.sass_functions(_listing(lines)).values()
    assert cs.sass_loop(insns, labels, "MUFU.RCP", 1, per_full) == want


# The sweep kernel's instances as the profiler (demangled) and cuobjdump
# (mangled, lower-cased by the profile's bucketing) name them.
INSTANCES = [
    ("K2", "void culled_kernel<256, false, 4>(int const*, int const*, int, "
           "float const*, int, float const*, int, float*)",
     "_Z13culled_kernelILi256ELb0ELi4EEvPKiS1_iPKfiS3_iPf"),
    ("K4", "void culled_kernel<512, false, 4>(int const*, int const*, int, "
           "float const*, int, float const*, int, float*)",
     "_Z13culled_kernelILi512ELb0ELi4EEvPKiS1_iPKfiS3_iPf"),
    ("K3", "void culled_kernel<512, true, 2>(int const*, int const*, int, "
           "float const*, int, float const*, int, float*)",
     "_Z13culled_kernelILi512ELb1ELi2EEvPKiS1_iPKfiS3_iPf"),
]


@pytest.mark.parametrize("key, demangled, mangled", INSTANCES,
                         ids=[k for k, _, _ in INSTANCES])
def test_sweep_instance_names(key, demangled, mangled):
    """Each instance of the sweep kernel gets its own profile bucket from
    either form of its name, and its SASS symbol matches its instance
    only."""
    cs = _chip_smoke()
    bucket = {"K2": "K2 sweep", "K3": "K3 brute", "K4": "K4 stream"}[key]
    assert cs.sweep_instance(demangled.lower()) == bucket
    assert cs.sweep_instance(mangled.lower()) == bucket
    for other, _, name in INSTANCES:
        assert (cs.KERNEL_SYMBOLS[key] in name) == (other == key)


def test_light_kernel_symbol():
    """K5's SASS symbol is its shipped instance, light_kernel<128, 2>, not
    another shape's; K5 is counted with its division's second marker; no
    kernel is left in its first design."""
    cs = _chip_smoke()
    sym = cs.KERNEL_SYMBOLS["K5"]
    assert sym in "_Z12light_kernelILi128ELi2EEvPKiS1_iPKfiS3_iPf"
    assert sym not in "_Z12light_kernelILi128ELi4EEvPKiS1_iPKfiS3_iPf"
    assert cs.SASS_MARKERS["K5"] == ("MUFU.RCP", 1, 1)
    assert all(v == "hopper-redesign" for v in cs.DESIGN.values())
