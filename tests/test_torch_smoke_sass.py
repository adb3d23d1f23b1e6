"""chip_smoke.sass_loop, the count of SASS instructions a test in a kernel's
inner loop, on small hand-written `cuobjdump -sass` listings: the counts of
a loop with a warp skip, and no count (None) where the walk of the loop's
paths stops at its cap or gives a skipping path more instructions than the
full one."""

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


@pytest.mark.parametrize("lines, want", [
    (SKIP, {"tests_per_iteration": 1.0, "per_test_full": 7.0,
            "per_test_mid": None, "per_test_skip": 5.0, "paths": 2}),
    (MANY, None),
    (WRONG, None),
], ids=["warp_skip", "path_cap", "skip_longer_than_full"])
def test_sass_loop(lines, want):
    cs = _chip_smoke()
    (insns, labels), = cs.sass_functions(_listing(lines)).values()
    assert cs.sass_loop(insns, labels, "MUFU.RCP", 1) == want


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
