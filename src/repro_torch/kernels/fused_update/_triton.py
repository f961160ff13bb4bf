"""The Triton body of the fused stage kernel (see :mod:`.kernel`).

Imports ``triton`` at module level, so it is imported only by
``kernel.fused_stage_launch``, at the first launch: hosts without Triton
import the rest of the package.
"""

import triton
import triton.language as tl


@triton.jit
def fused_stage_kernel(
    s_ptr, gs_ptr, r_ptr, sg_ptr, x_ptr, g_ptr, m_ptr, mix_ptr, xp_ptr, mp_ptr,
    ox_ptr, op_ptr, om_ptr,
    numel, beta, omb, wd,
    OP: tl.constexpr,
    HAS_X: tl.constexpr, HAS_G: tl.constexpr, HAS_M: tl.constexpr,
    HAS_MIX: tl.constexpr, HAS_PREV: tl.constexpr,
    NESTEROV: tl.constexpr, COUPLED_WD: tl.constexpr, DECOUPLED_WD: tl.constexpr,
    CLIP: tl.constexpr, LARS: tl.constexpr,
    NODE_GRID: tl.constexpr, GS_COL: tl.constexpr, R_COL: tl.constexpr,
    SG_COL: tl.constexpr, BLOCK: tl.constexpr,
):
    # beta, omb (= 1 - beta, rounded on the host as the plain version does)
    # and wd are the MathCtx constants; s_ptr -> [lr, gs, r, sg].
    # NODE_GRID: a 2-D grid (blocks of one node's ``numel`` elements, nodes)
    # over a stacked operand; else a 1-D grid over all ``numel`` elements.
    # GS_COL / R_COL override the svec scalar: 0 none, 1 per node
    # (``ptr[node]``), 2 per row (``ptr[node * rows + block]``: with BLOCK
    # equal to the plane's row width a program covers exactly one row).
    # Each is one scalar load per program.
    if NODE_GRID:
        blk = tl.program_id(0).to(tl.int64)
        node = tl.program_id(1).to(tl.int64)
        local = blk * BLOCK + tl.arange(0, BLOCK).to(tl.int64)
        mask = local < numel
        offs = node * numel + local
    else:
        pid = tl.program_id(0).to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK).to(tl.int64)
        mask = offs < numel
    lr = tl.load(s_ptr)
    if GS_COL == 1:
        gs = tl.load(gs_ptr + node)
    elif GS_COL == 2:
        gs = tl.load(gs_ptr + node * tl.num_programs(0) + blk)
    else:
        gs = tl.load(s_ptr + 1)
    if R_COL == 1:
        r = tl.load(r_ptr + node)
    elif R_COL == 2:
        r = tl.load(r_ptr + node * tl.num_programs(0) + blk)
    else:
        r = tl.load(s_ptr + 2)
    if SG_COL == 1:
        sg = tl.load(sg_ptr + node)
    else:
        sg = tl.load(s_ptr + 3)
    safe_lr = tl.maximum(lr, 1e-12)

    if HAS_X:
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    if HAS_M:
        m = tl.load(m_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    if HAS_MIX:
        mix = tl.load(mix_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    if HAS_PREV:
        xp = tl.load(xp_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        mp = tl.load(mp_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    if HAS_G:
        # g_eff: clip scale, then coupled wd, then the LARS ratio
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        if CLIP:
            g = gs * g
        if COUPLED_WD:
            g = wd * x + g
        if LARS:
            g = r * g

    # ---- PRE ops: payload (+ momentum) ----
    if OP == 0:  # grad_step
        tl.store(op_ptr + offs, x - lr * g, mask=mask)
    if OP == 1:  # identity_g
        tl.store(op_ptr + offs, g, mask=mask)
    if OP == 2:  # momentum_payload
        m_new = beta * m + g
        if NESTEROV:
            tl.store(op_ptr + offs, x - lr * (beta * m_new + g), mask=mask)
        else:
            tl.store(op_ptr + offs, x - lr * m_new, mask=mask)
        tl.store(om_ptr + offs, m_new, mask=mask)
    if OP == 3:  # momentum_accum
        m_new = beta * m + g
        tl.store(op_ptr + offs, m_new, mask=mask)
        tl.store(om_ptr + offs, m_new, mask=mask)
    if OP == 4:  # x_minus_lr_m
        tl.store(op_ptr + offs, x - lr * m, mask=mask)
    if OP == 5:  # momentum_keep_x
        tl.store(op_ptr + offs, x, mask=mask)
        tl.store(om_ptr + offs, beta * m + g, mask=mask)
    if OP == 6:  # qg_payload
        tl.store(op_ptr + offs, x - lr * (beta * m + g), mask=mask)
    if OP == 7:  # d2_payload
        m_new = beta * m + g
        tl.store(op_ptr + offs, 2.0 * x - xp - lr * (m_new - mp), mask=mask)
        tl.store(om_ptr + offs, m_new, mask=mask)

    # ---- POST ops: recombine (x_new gets the decoupled decay) ----
    if OP == 8:  # assign_x
        x_new = mix
    if OP == 9:  # assign_m
        tl.store(om_ptr + offs, mix, mask=mask)
    if OP == 10:  # mix_minus_lr_m
        x_new = mix - lr * m
    if OP == 11:  # momentum_step
        m_new = beta * m + mix
        if NESTEROV:
            x_new = x - lr * (beta * m_new + mix)
        else:
            x_new = x - lr * m_new
        tl.store(om_ptr + offs, m_new, mask=mask)
    if OP == 12:  # qg_post
        m_new = beta * m + tl.math.div_rn(omb * (x - mix), safe_lr)
        x_new = mix
        tl.store(om_ptr + offs, m_new, mask=mask)
    if OP == 13:  # decentlam_post
        g_tilde = tl.math.div_rn(x - mix, safe_lr)
        m_new = beta * m + g_tilde
        if NESTEROV:
            x_new = x - lr * (beta * m_new + g_tilde)
        else:
            x_new = x - lr * m_new
        tl.store(om_ptr + offs, m_new, mask=mask)
    if OP == 14:  # decentlam_sa_post
        drift = tl.math.div_rn(x - mix, safe_lr)
        m_new = beta * m + (sg * drift + (1.0 - sg) * g)
        if NESTEROV:
            x_new = x - lr * (sg * (beta * m_new) + drift)
        else:
            x_new = x - lr * (sg * (beta * m) + drift)
        tl.store(om_ptr + offs, m_new, mask=mask)
    if OP >= 8:
        if OP != 9:
            if DECOUPLED_WD:
                x_new = x_new - lr * wd * x_new
            tl.store(ox_ptr + offs, x_new.to(ox_ptr.dtype.element_ty), mask=mask)
