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


def hot(fn, rsq_per_trip=1):
    """:func:`sb.nest_counts` of a kernel whose lane-step is one trip of its
    step loop, with that loop's ``unroll`` and ``span``."""
    counts = sb.nest_counts(fn, ((rsq_per_trip, 1),))
    assert counts.pop("tail_issue") == 0
    return {**counts, "unroll": counts["unroll"][0], "span": counts["span"][0]}


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
    counts = hot(sb.find_function(funcs, "stepILi0E"))
    assert counts == {"fp32": 2, "int": 1, "mufu": 2, "issue": 7, "unroll": 1, "span": 0x90}


def test_hot_loop_unroll_and_nested_loop(funcs):
    """Two MUFU.RSQ in the trip: an unroll of 2; the region holding the inner
    loop 0x40..0x50 is skipped."""
    counts = hot(sb.find_function(funcs, "laneILi1E"))
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
    counts = hot(chain, rsq_per_trip=3)
    # kept: 0x10 RSQ, 0x20 FMUL, 0x30 RSQ, 0x40 RSQ, 0x50 BRA, 0xa0 FADD, 0xb0 BRA
    assert counts == {"fp32": 2, "int": 0, "mufu": 3, "issue": 7, "unroll": 1, "span": 0xA0}
    # the old rule (one RSQ per trip) reads the three roots as an unroll of 3
    assert hot(chain)["unroll"] == 3
    with pytest.raises(ValueError, match="not a multiple of 2"):
        hot(chain, rsq_per_trip=2)


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
    counts = sb.nest_counts(fn, (((1, 3), 1),))
    # pre-pass: RSQ, FADD, IADD3, BRA; replay: 3 RSQ, FFMA, BRA
    assert counts == {"fp32": 2, "int": 1, "mufu": 4, "issue": 9, "unroll": (1, 1),
                      "span": (0x30, 0x40), "tail_issue": 0}
    assert hot(fn)["span"] == 0x30
    with pytest.raises(ValueError, match="not a multiple of 3"):
        hot(fn, rsq_per_trip=3)
    with pytest.raises(ValueError, match="not a multiple of 2"):
        sb.nest_counts(fn, (((1, 2), 1),))


def test_two_pass_needs_two_inner_loops(funcs):
    with pytest.raises(ValueError, match="found 1"):
        sb.nest_counts(sb.find_function(funcs, "stepILi0E"), (((1, 3), 1),))


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
        hot([i for i in sb.find_function(funcs, "stepILi0E")
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


NEST_LISTING = """
        code for sm_90a
                Function : _ZN10optionslab6ladderILi0EEEvNS_4ArgsE
        /*0000*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0010*/                   IADD3 R1, R1, 0x1, RZ ;                /* 0x0000000101017810 */
        /*0020*/               @!P0 BRA 0x140 ;                           /* 0x0000000000008947 */
        /*0030*/                   MUFU.RSQ R2, R3 ;                      /* 0x0000000300027308 */
        /*0040*/                   I2F.U32 R4, R4 ;                       /* 0x0000000400047306 */
        /*0050*/               @!P1 BRA 0x80 ;                            /* 0x0000000000009947 */
        /*0060*/                   CALL.REL.NOINC 0x300 ;                 /* 0x0000000000007944 */
        /*0070*/                   NOP ;                                  /* 0x0000000000007918 */
        /*0080*/                   STS [R5], R2 ;                         /* 0x0000000205007388 */
        /*0090*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;          /* 0x0000000000007b1d */
        /*00a0*/               @!P2 BRA 0x120 ;                           /* 0x000000000000a947 */
        /*00b0*/                   LDS R6, [R5] ;                         /* 0x0000000005067984 */
        /*00c0*/                   MUFU.RSQ R7, R6 ;                      /* 0x0000000600077308 */
        /*00d0*/                   FMUL R8, R7, R7 ;                      /* 0x0000000707087220 */
        /*00e0*/                   MUFU.RSQ R9, R8 ;                      /* 0x0000000800097308 */
        /*00f0*/                   FADD R10, R10, R9 ;                    /* 0x000000090a0a7221 */
        /*0100*/                   IADD3 R11, R11, 0x1, RZ ;              /* 0x000000010b0b7810 */
        /*0110*/                @P3 BRA 0xb0 ;                            /* 0xfffffff000003947 */
        /*0120*/                   LOP3.LUT R12, R12, 0x1, RZ, 0x3c, !PT ; /* 0x000000010c0c7812 */
        /*0130*/                @P4 BRA 0x30 ;                            /* 0xfffffef000004947 */
        /*0140*/                   MUFU.EX2 R13, R13 ;                    /* 0x0000000d000d7308 */
        /*0150*/               @!P5 BRA 0x180 ;                           /* 0x000000000000d947 */
        /*0160*/                   FMUL R14, R13, R13 ;                   /* 0x0000000d0d0e7220 */
        /*0170*/                   FADD R15, R15, R14 ;                   /* 0x0000000e0f0f7221 */
        /*0180*/                   FADD R16, R16, R13 ;                   /* 0x0000000d10107221 */
        /*0190*/                @P6 BRA 0x10 ;                            /* 0xfffffe7000006947 */
        /*01a0*/                   SHFL.DOWN PT, R17, R16, 0x10, 0x1f ;   /* 0x0000001011117f89 */
        /*01b0*/                   EXIT ;                                 /* 0x000000000000794d */

                Function : _ZN10optionslab4termILi0EEEvNS_4ArgsE
        /*0000*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0010*/                   MUFU.RSQ R1, R2 ;                      /* 0x0000000200017308 */
        /*0020*/                   FFMA R3, R3, R1, R3 ;                  /* 0x0000000103037223 */
        /*0030*/                @P0 BRA 0x10 ;                            /* 0xffffffd000000947 */
        /*0040*/                   MUFU.EX2 R4, R3 ;                      /* 0x0000000300047308 */
        /*0050*/                @P1 BRA 0x90 ;                            /* 0x0000000000001947 */
        /*0060*/                   FMUL R5, R4, R4 ;                      /* 0x0000000404057220 */
        /*0070*/                   FMUL R5, R5, R4 ;                      /* 0x0000000405057220 */
        /*0080*/                   BRA 0xa0 ;                             /* 0x0000000000007947 */
        /*0090*/                   FADD R5, R4, R4 ;                      /* 0x0000000404057221 */
        /*00a0*/                   FMNMX R6, R5, RZ, !PT ;                /* 0x000000ff05067209 */
        /*00b0*/                   EXIT ;                                 /* 0x000000000000794d */
        /*00c0*/                   BRA 0xc0;                              /* 0xfffffff000007947 */
"""


@pytest.fixture(scope="module")
def nest_funcs():
    return sb.parse_functions(NEST_LISTING)


def test_nest_counts_weights_each_loop_and_the_tail(nest_funcs):
    """A split ladder: per unit (loop 0x10..0x190) a chunk loop 0x30..0x130
    that draws (one root; its slow-path call 0x50..0x80 and the guarded
    advance loop 0xa0..0x120 left out) and an advance loop 0xb0..0x110 (two
    roots a trip), then the payoff. Per lane-step: the advance loop × 7, the
    chunk loop × 1, and the tail 0x140..0x190 along its shortest path (the
    warp-uniform branch 0x150 taken: 4 instructions) once per lane of 4
    steps."""
    fn = sb.find_function(nest_funcs, "ladderILi0E")
    counts = sb.nest_counts(fn, ((2, 7), (1, 1)), tail=1, n_steps=4)
    # advance: LDS, RSQ, FMUL, RSQ, FADD, IADD3, BRA; chunk: RSQ, I2F, BRA,
    # STS, BAR, BRA, LOP3, BRA; tail: EX2, BRA, FADD, BRA
    assert counts == {"fp32": 7 * 2 + 0 + 0.25, "int": 7 * 1 + 1, "mufu": 7 * 2 + 2 + 0.25,
                      "issue": 7 * 7 + 8 + 0.25 * 4, "unroll": (1, 1), "span": (0x60, 0x100),
                      "tail_issue": 4}
    # level 0 alone is the hot loop
    inner = hot(fn, rsq_per_trip=2)
    assert inner["issue"] == 7 and inner["span"] == 0x60
    with pytest.raises(ValueError, match="not a multiple of 3"):
        sb.nest_counts(fn, ((2, 7), (3, 1)))
    with pytest.raises(ValueError, match="holds no MUFU.RSQ"):  # the unit loop's own code
        sb.nest_counts(fn, ((2, 7), (1, 1), (1, 1)))


def test_nest_counts_tail_takes_the_shortest_kind(nest_funcs):
    """A terminal kernel: a one-root step loop, then an epilogue whose payoff
    kind is a runtime branch. The tail runs to the function's end (no loop
    encloses the step loop) and counts the shorter arm (EX2, BRA, FADD,
    FMNMX, EXIT), never both."""
    fn = sb.find_function(nest_funcs, "termILi0E")
    counts = sb.nest_counts(fn, ((1, 1),), tail=1.0)
    assert counts == {"fp32": 1 + 2, "int": 0, "mufu": 1 + 1, "issue": 3 + 5, "unroll": (1,),
                      "span": (0x20,), "tail_issue": 5}
    assert sb.nest_counts(fn, ((1, 1),)) == {**counts, "fp32": 1, "mufu": 1, "issue": 3,
                                             "tail_issue": 0}
    with pytest.raises(ValueError, match="no loop encloses"):
        sb.nest_counts(fn, ((1, 1), (1, 1)))


def test_digest_matches_compare(funcs):
    changed = sb.parse_functions(LISTING.replace("FMUL R2, R2, R3 ;", "FADD R2, R2, R3 ;"))
    assert sb.digest(funcs, "step") == sb.digest(changed, "step")
    assert sb.digest(funcs, "chain") != sb.digest(changed, "chain")
    assert sb.digest(funcs, "optionslab")[0] == 3
    assert sb.digest(funcs, "nothing") == (0, sb.digest({}, "x")[1])


SPLIT_LISTING = """
        code for sm_90a
                Function : _ZN10optionslab5splitILi0EEEvNS_4ArgsE
        /*0000*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0010*/                   UMOV UR4, URZ ;                        /* 0x0000003f00047882 */
        /*0020*/                   I2FP.F32.S32 R3, R10 ;                 /* 0x0000000a00037245 */
        /*0030*/                   MUFU.RSQ R2, R3 ;                      /* 0x0000000300027308 */
        /*0040*/                   FMUL R4, R2, R2 ;                      /* 0x0000000202047220 */
        /*0050*/                   SHF.L.U32 R5, R0, 0x2, RZ ;            /* 0x0000000200057819 */
        /*0060*/                   UIMAD UR5, UR4, 0x80, URZ ;            /* 0x00000080040578a4 */
        /*0070*/                   STS [R5+UR5], R4 ;                     /* 0x0000000405007988 */
        /*0080*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;          /* 0x0000000000007b1d */
        /*0090*/                   ISETP.GE.AND P0, PT, R6, 0x1, PT ;     /* 0x000000010600780c */
        /*00a0*/               @!P0 BRA 0x140 ;                           /* 0x0000000000248947 */
        /*00b0*/                   UMOV UR6, URZ ;                        /* 0x0000003f00067882 */
        /*00c0*/                   ULEA UR7, UR6, UR5, 0x7 ;              /* 0x0000000506077291 */
        /*00d0*/                   LDS R7, [R5+UR7] ;                     /* 0x0000000705077984 */
        /*00e0*/                   MUFU.RSQ R8, R7 ;                      /* 0x0000000700087308 */
        /*00f0*/                   FADD R9, R9, R8 ;                      /* 0x0000000809097221 */
        /*0100*/                   UIADD3 UR6, UR6, 0x1, URZ ;            /* 0x0000000106067890 */
        /*0110*/                   UISETP.GE.AND UP0, UPT, UR6, UR8, UPT ; /* 0x000000080600728c */
        /*0120*/                   PLOP3.LUT P1, PT, PT, PT, UP0, 0x80, 0x0 ; /* 0x000000000000781c */
        /*0130*/               @!P1 BRA 0xc0 ;                            /* 0xffffff8000009947 */
        /*0140*/                   ULOP3.LUT UR4, UR4, 0x1, URZ, 0x3c, !UPT ; /* 0x0000000104047892 */
        /*0150*/                   IADD3 R10, R10, 0x7, RZ ;              /* 0x000000070a0a7810 */
        /*0160*/                   ISETP.LT.AND P2, PT, R10, R11, PT ;    /* 0x0000000b0a00720c */
        /*0170*/                @P2 BRA 0x20 ;                            /* 0xfffffea000002947 */
        /*0180*/                   FADD R12, R9, R9 ;                     /* 0x000000090c0c7221 */
        /*0190*/                   EXIT ;                                 /* 0x000000000000794d */

                Function : _ZN10optionslab5guardILi0EEEvNS_4ArgsE
        /*0000*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0010*/                   ISETP.GE.AND P0, PT, R1, R2, PT ;      /* 0x000000020100720c */
        /*0020*/                @P0 BRA 0x80 ;                            /* 0x0000000000140947 */
        /*0030*/                   MUFU.RSQ R3, R4 ;                      /* 0x0000000400037308 */
        /*0040*/               @!P1 BRA 0x70 ;                            /* 0x0000000000089947 */
        /*0050*/                   CALL.REL.NOINC 0x200 ;                 /* 0x0000000000007944 */
        /*0060*/                   NOP ;                                  /* 0x0000000000007918 */
        /*0070*/                   FMUL R5, R3, R3 ;                      /* 0x0000000303057220 */
        /*0080*/                   FADD R6, R6, R5 ;                      /* 0x0000000506067221 */
        /*0090*/                @P2 BRA 0x10 ;                            /* 0xffffff7000002947 */
        /*00a0*/                   EXIT ;                                 /* 0x000000000000794d */
"""


@pytest.fixture(scope="module")
def split_funcs():
    return sb.parse_functions(SPLIT_LISTING)


def test_nest_counts_leaves_out_the_layouts_bookkeeping(split_funcs):
    """A split kernel: each trip of the chunk loop 0x20..0x170 draws one
    value (a root) into shared memory behind a barrier, and the advance loop
    0xc0..0x130 (4 trips a lane-step) reads it back. With
    ``bookkeeping=False`` what only the layout needs goes: the store, the
    barrier and the load, their addresses (lane·4, the buffer, the step),
    both loops' counters and branches, the buffer's toggle and the advance
    loop's zero-trip test. The draw's step counter 0x150 stays (the draw
    reads it), and so does the advance's sum 0xf0, which only its own next
    trip reads in the loop. The region the zero-trip test 0xa0 jumps over
    holds the advance loop, so, as a slow path would, its own code 0xb0
    counts with neither level."""
    fn = sb.find_function(split_funcs, "splitILi0E")
    kept = sb.nest_counts(fn, ((1, 4), (1, 1)), tail=1, n_steps=4)
    # advance: ULEA, LDS, RSQ, FADD, UIADD3, UISETP, PLOP3, BRA; chunk: I2FP,
    # RSQ, FMUL, SHF, UIMAD, STS, BAR, ISETP, BRA, ULOP3, IADD3, ISETP, BRA;
    # tail: FADD, EXIT
    assert kept == {"fp32": 4 * 1 + 1 + 0.25, "int": 4 * 1 + 5, "mufu": 4 * 1 + 1,
                    "issue": 4 * 8 + 13 + 0.25 * 2, "unroll": (1, 1), "span": (0x70, 0x150),
                    "tail_issue": 2}
    # left: advance RSQ, FADD; chunk I2FP, RSQ, FMUL, IADD3
    assert sb.nest_counts(fn, ((1, 4), (1, 1)), tail=1, n_steps=4, bookkeeping=False) == {
        **kept, "int": 2, "issue": 4 * 2 + 4 + 0.25 * 2}


def test_a_branch_around_a_root_skips_no_slow_path(split_funcs):
    """A guarded draw: the branch 0x20 jumps over the draw, whose root
    0x30 is the trip's own work, so only the slow-path call 0x40..0x70 is
    left out; a skipped root would leave the loop without its MUFU.RSQ."""
    counts = sb.nest_counts(sb.find_function(split_funcs, "guardILi0E"), ((1, 1),))
    # ISETP, BRA, RSQ, BRA, FMUL, FADD, BRA
    assert counts == {"fp32": 2, "int": 1, "mufu": 1, "issue": 7, "unroll": (1,),
                      "span": (0x80,), "tail_issue": 0}


@pytest.mark.parametrize("line,dests,reads", [
    ("ISETP.GE.AND P0, PT, R5, R7, PT", ["P0"], [("R5", False), ("R7", False)]),
    ("IMAD.WIDE.U32 R2, R3, -0x326172a9, RZ", ["R2", "R3"], [("R3", False)]),
    ("IADD3 R4, P1, R5, 0x1, RZ", ["R4", "P1"], [("R5", False)]),
    ("STS [R6+0x380], R3", [], [("R6", True), ("R3", False)]),
    ("LDS R13, [R11+UR14+0x380]", ["R13"], [("R11", True), ("UR14", True)]),
    ("@!P0 BRA 0x70", [], [("P0", False)]),
    ("PLOP3.LUT P0, PT, PT, PT, UP0, 0x80, 0x0", ["P0"], [("UP0", False)]),
    ("ULDC.64 UR14, c[0x0][0x218]", ["UR14", "UR15"], []),
    ("@P3 LDG.E.64 R2, desc[UR4][R6.64]", ["R2", "R3"],
     [("P3", False), ("UR4", True), ("R6", True), ("R7", True)]),
])
def test_defs_reads(line, dests, reads):
    """What an instruction writes and reads, and which reads are addresses."""
    (fn,) = sb.parse_functions(f"Function : f\n        /*0000*/ {line} ;\n").values()
    assert sb._defs_reads(fn[0]) == (dests, reads)
