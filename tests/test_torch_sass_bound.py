"""The SASS instruction counter behind the kernels' bounds, on a listing in
``cuobjdump -sass`` form (the card's own listing is read by
``chip_smoke.py``)."""

import pytest

from optionslab_tpu_torch.ops import sass_bound as sb

LISTING = """
        code for sm_90a
                Function : _ZN10optionslab4stepILi0EEEvNS_4ArgsE
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
        /*0010*/                   FFMA R2, R3, R4, R5 ;                  /* 0x0000000403027223 */
        /*0020*/                   MUFU.RSQ R6, R7 ;                      /* 0x0000000700067308 */
        /*0030*/               @!P0 BRA 0x70 ;                            /* 0x0000000000108947 */
        /*0040*/                   CALL.REL.NOINC 0x100 ;                 /* 0x0000000000047944 */
        /*0050*/                   BRA 0x70 ;                             /* 0x0000000000047947 */
        /*0060*/                   NOP ;                                  /* 0x0000000000007918 */
        /*0070*/                   IADD3 R1, R1, 0x1, RZ ;                /* 0x0000000101017810 */
        /*0080*/                   FMUL R2, R2, R2 ;                      /* 0x0000000202027220 */
        /*0090*/                   MUFU.EX2 R3, R3 ;                      /* 0x0000000300037308 */
        /*00a0*/                @P1 BRA 0x10 ;                            /* 0xffffff6000001947 */
        /*00b0*/                   EXIT ;                                 /* 0x000000000000794d */
                ..........

                Function : _ZN10optionslab4laneILi1EEEvNS_4ArgsE
        /*0000*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0010*/                   MUFU.RSQ R6, R7 ;                      /* 0x0000000700067308 */
        /*0020*/                   LOP3.LUT R1, R1, 0xff, RZ, 0xc0, !PT ; /* 0x000000ff01017812 */
        /*0030*/               @!P2 BRA 0x70 ;                            /* 0x0000000000108947 */
        /*0040*/                   FADD R8, R8, 1 ;                       /* 0x3f80000008087421 */
        /*0050*/                   BRA 0x40 ;                             /* 0xfffffff000007947 */
        /*0060*/                   NOP ;                                  /* 0x0000000000007918 */
        /*0070*/                   MUFU.RSQ R9, R7 ;                      /* 0x0000000700097308 */
        /*0080*/                   I2F.U32 R4, R4 ;                       /* 0x0000000400047306 */
        /*0090*/                @P1 BRA 0x10 ;                            /* 0xffffff7000001947 */
        /*00a0*/                   EXIT ;                                 /* 0x000000000000794d */

                Function : _ZN10optionslab5chainILi0EEEvNS_4ArgsE
        /*0000*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0010*/                   MUFU.RSQ R6, R7 ;                      /* 0x0000000700067308 */
        /*0020*/                   FMUL R2, R2, R3 ;                      /* 0x0000000302027220 */
        /*0030*/                   MUFU.RSQ R8, R9 ;                      /* 0x0000000900087308 */
        /*0040*/                   MUFU.RSQ R10, R11 ;                    /* 0x0000000b000a7308 */
        /*0050*/               @!P0 BRA 0xa0 ;                            /* 0x0000000000108947 */
        /*0060*/                   MUFU.EX2 R12, R12 ;                    /* 0x0000000c000c7308 */
        /*0070*/                   SHFL.DOWN PT, R13, R12, 0x10, 0x1f ;   /* 0x0000000c0d007f89 */
        /*0080*/                   IADD3 R14, R14, 0x1, RZ ;              /* 0x000000010e0e7810 */
        /*0090*/                @P2 BRA 0x60 ;                            /* 0xfffffffc00002947 */
        /*00a0*/                   FADD R2, R2, R6 ;                      /* 0x0000000602027221 */
        /*00b0*/                @P1 BRA 0x10 ;                            /* 0xffffff5000001947 */
        /*00c0*/                   EXIT ;                                 /* 0x000000000000794d */
"""


@pytest.fixture(scope="module")
def funcs():
    return sb.parse_functions(LISTING)


def test_parse_functions(funcs):
    assert sorted(funcs) == ["_ZN10optionslab4laneILi1EEEvNS_4ArgsE",
                             "_ZN10optionslab4stepILi0EEEvNS_4ArgsE",
                             "_ZN10optionslab5chainILi0EEEvNS_4ArgsE"]
    step = sb.find_function(funcs, "stepILi0E")
    assert [i.addr for i in step] == list(range(0, 0xC0, 0x10))
    bra = step[3]
    assert bra.pred and bra.op == "BRA" and bra.branch_target() == 0x70
    assert step[2].op == "MUFU.RSQ" and step[2].base == "MUFU"
    assert step[10].branch_target() == 0x10 and step[11].branch_target() is None


def test_hot_loop_skips_slow_path(funcs):
    """The loop 0x10..0xa0 minus the call region 0x40..0x60 its branch jumps over."""
    counts = sb.hot_loop_counts(sb.find_function(funcs, "stepILi0E"))
    assert counts == {"fp32": 2, "int": 1, "mufu": 2, "issue": 7, "unroll": 1, "span": 0x90}


def test_hot_loop_unroll_and_nested_loop(funcs):
    """Two MUFU.RSQ in the trip: an unroll of 2; the region holding the inner
    loop 0x40..0x50 is skipped."""
    counts = sb.hot_loop_counts(sb.find_function(funcs, "laneILi1E"))
    # kept: 0x10 RSQ, 0x20 LOP3, 0x30 BRA, 0x70 RSQ, 0x80 I2F, 0x90 BRA
    assert counts["unroll"] == 2
    assert counts["issue"] == 3.0 and counts["mufu"] == 1.5 and counts["int"] == 0.5
    assert counts["fp32"] == 0.0


def test_step_loop_with_several_roots_and_an_expiry_loop(funcs):
    """A Heston-style step loop: three MUFU.RSQ per trip (the Box–Muller root
    and one sqrtf(v⁺) per branch) and the chain's expiry loop behind a
    forward branch. The innermost loop (the expiry loop) holds no RSQ, so
    the step loop is picked, the expiry region 0x60..0x90 is left out, and
    with ``rsq_per_trip=3`` one trip is one step, not a third of one."""
    chain = sb.find_function(funcs, "chainILi0E")
    counts = sb.hot_loop_counts(chain, rsq_per_trip=3)
    # kept: 0x10 RSQ, 0x20 FMUL, 0x30 RSQ, 0x40 RSQ, 0x50 BRA, 0xa0 FADD, 0xb0 BRA
    assert counts == {"fp32": 2, "int": 0, "mufu": 3, "issue": 7, "unroll": 1, "span": 0xA0}
    # the old rule (one RSQ per trip) reads the three roots as an unroll of 3
    assert sb.hot_loop_counts(chain)["unroll"] == 3
    with pytest.raises(ValueError, match="not a multiple of 2"):
        sb.hot_loop_counts(chain, rsq_per_trip=2)


BRIDGE_LISTING = """
        code for sm_90a
                Function : _ZN10optionslab6bridgeILi2EEEvNS_4ArgsE
        /*0000*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0010*/                   MUFU.RSQ R1, R2 ;                      /* 0x0000000200017308 */
        /*0020*/                   FMUL R3, R3, R4 ;                      /* 0x0000000403037220 */
        /*0030*/                   MUFU.RSQ R5, R6 ;                      /* 0x0000000600057308 */
        /*0040*/                   FADD R7, R7, R5 ;                      /* 0x0000000507077221 */
        /*0050*/                   IADD3 R8, R8, 0x1, RZ ;                /* 0x0000000108087810 */
        /*0060*/                @P0 BRA 0x30 ;                            /* 0xfffffffc00000947 */
        /*0070*/                   FMUL R9, R9, R10 ;                     /* 0x0000000a09097220 */
        /*0080*/                   MUFU.RSQ R11, R12 ;                    /* 0x0000000c000b7308 */
        /*0090*/                   MUFU.RSQ R13, R14 ;                    /* 0x0000000e000d7308 */
        /*00a0*/                   MUFU.RSQ R15, R16 ;                    /* 0x00000010000f7308 */
        /*00b0*/                   FFMA R17, R17, R18, R19 ;              /* 0x0000001211117223 */
        /*00c0*/                @P1 BRA 0x80 ;                            /* 0xfffffffc00001947 */
        /*00d0*/                   IADD3 R20, R20, 0x1, RZ ;              /* 0x0000000114147810 */
        /*00e0*/                @P2 BRA 0x20 ;                            /* 0xfffffff800002947 */
        /*00f0*/                   EXIT ;                                 /* 0x000000000000794d */
"""


def test_two_pass_bridge_counts_both_loops():
    """A bridge-QMC kernel: per segment (the loop 0x20..0xe0) a pre-pass loop
    0x30..0x60 (one Box–Muller per trip) and a replay loop 0x80..0xc0 (the
    Box–Muller root and one sqrtf(v⁺) per branch). A step costs one trip of
    each, so their per-trip counts add; the segment loop, which holds both,
    is not a hot loop, and the single-loop rule alone reads only the
    pre-pass."""
    fn = sb.find_function(sb.parse_functions(BRIDGE_LISTING), "bridgeILi2E")
    counts = sb.two_pass_counts(fn, rsq_per_trip=(1, 3))
    # pre-pass: RSQ, FADD, IADD3, BRA; replay: 3 RSQ, FFMA, BRA
    assert counts == {"fp32": 2, "int": 1, "mufu": 4, "issue": 9, "unroll": (1, 1),
                      "span": (0x30, 0x40)}
    assert sb.hot_loop_counts(fn)["span"] == 0x30
    with pytest.raises(ValueError, match="not a multiple of 3"):
        sb.hot_loop_counts(fn, rsq_per_trip=3)
    with pytest.raises(ValueError, match="not a multiple of 2"):
        sb.two_pass_counts(fn, rsq_per_trip=(1, 2))


def test_two_pass_needs_two_inner_loops(funcs):
    with pytest.raises(ValueError, match="found 1"):
        sb.two_pass_counts(sb.find_function(funcs, "stepILi0E"))


def test_bound_ms_picks_busiest_pipe():
    counts = {"fp32": 128, "int": 80, "mufu": 10, "issue": 200}
    n_sm, clock = 132, 1.98e9
    trips = n_sm * clock * 1e-3  # one trip per SM and clock for 1 ms
    ms, pipe = sb.bound_ms(counts, trips, n_sm, clock)
    assert pipe == "issue" and ms == pytest.approx(200 / 128)
    ms, pipe = sb.bound_ms({**counts, "int": 160}, trips, n_sm, clock)
    assert pipe == "int" and ms == pytest.approx(160 / 64)
    ms, pipe = sb.bound_ms({**counts, "mufu": 30}, trips, n_sm, clock)
    assert pipe == "mufu" and ms == pytest.approx(30 / 16)


def test_errors(funcs):
    with pytest.raises(KeyError):
        sb.find_function(funcs, "optionslab")  # three match
    with pytest.raises(KeyError):
        sb.find_function(funcs, "nothing")
    with pytest.raises(ValueError, match="MUFU.RSQ"):
        sb.hot_loop_counts([i for i in sb.find_function(funcs, "stepILi0E")
                            if not i.op.startswith("MUFU.RSQ")])


def test_compare_counts_same_and_changed_functions(funcs):
    changed = LISTING.replace("FMUL R2, R2, R3 ;", "FADD R2, R2, R3 ;")
    other = sb.parse_functions(changed.replace("Function : _ZN10optionslab4laneILi1EEEvNS_4ArgsE",
                                               "Function : _ZN10optionslab4laneILi2EEEvNS_4ArgsE"))
    assert sb.compare(funcs, funcs, "optionslab") == {"functions": [3, 3], "same": 3,
                                                      "instructions": [36, 36]}
    assert sb.compare(funcs, other, "chain") == {"functions": [1, 1], "same": 0,
                                                 "instructions": [13, 13]}
    assert sb.compare(funcs, other, "lane") == {"functions": [1, 1], "same": 0,
                                                "instructions": [11, 11]}
    assert sb.compare(funcs, other, "step") == {"functions": [1, 1], "same": 1,
                                                "instructions": [12, 12]}
    # the anonymous namespace nvcc names after the translation unit pairs up
    units = [sb.parse_functions(LISTING.replace("_ZN10optionslab4step",
                                                f"_ZN10optionslab{len(u)}{u}4step"))
             for u in ("_GLOBAL__N__1a2b3c4d_9_x_cu_5e6f", "_GLOBAL__N__0f0f0f0f_9_x_cu_7a7a")]
    assert sb.compare(*units, "step") == {"functions": [1, 1], "same": 1,
                                          "instructions": [12, 12]}
