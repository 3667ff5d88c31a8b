"""MPS reader (a copy of vanderbei_tpu/io/mps.py's Python reader; the
tests hold the two to equal output).

Feature-parity re-implementation of the reference's fixed-column MPS parser
(src/common/iolp.c:145-838), including its extensions and quirks:

- header keywords before NAME: MAX/MIN/SIGFIG/INFTOL/OBJ/RHS/RANGES/BOUNDS/
  VERBOSE/ITNLIM/TIMLIM (iolp.c:167-183); any unrecognized header line is
  stored as a generic named parameter (iolp.c:270-277).
- sections ROWS/COLUMNS/RHS/RANGES/BOUNDS/QUADS/ENDATA, recognized by their
  first three characters (newstate, iolp.c:1049-1064).
- row types N/L/E/G; the objective is the first N row, or the N row whose
  label contains the OBJ name (substring match quirk, iolp.c:379-384).
- L rows are negated and N rows stripped after parsing so every constraint
  reads  b <= Ax <= b+r  (iolp.c:670-722).
- integer MARKER lines toggle INTORG/INTEND (iolp.c:418-420).
- bound types LO/UP/FX/FR/PL/MI/BV/LI/UI/SC with the reference's exact
  semantics — notably MI sets u to the *previous* lower bound (iolp.c:560-562).
- QUADS section: lower-triangle quadratic objective term, symmetrized
  (iolp.c:583-645, 729-794).
- zero values in COLUMNS/RHS/RANGES are skipped exactly as the reference
  skips them (iolp.c:439,483,493,514,524).

The parser is host-side pure Python; it feeds the dense canonicalizer whose
arrays the solver moves to the device.
"""

from __future__ import annotations

import numpy as np

from ..core.lp import LP, INF, VAR_REAL, VAR_INTEGER, VAR_SEMICONT

# parser states
_HEADER, _NAME, _ROWS, _COLS, _RHS, _RNGS, _BNDS, _QUADS, _END = range(9)

_HEADER_KEYS = {
    "MAX", "SIGFIG", "INFTOL", "MIN", "OBJ", "RHS", "RANGES", "BOUNDS",
    "VERBOSE", "ITNLIM", "TIMLIM",
}


def _fields(line: str):
    """Split a data line at the reference's fixed columns (iolp.c:237-245,259-261).

    Returns (type, label0, label1, valstr1, label2, valstr2), whitespace-stripped.
    """
    line = line.rstrip("\n").ljust(79)
    return (
        line[1:3].strip(),
        line[4:12].strip(),
        line[14:22].strip(),
        line[24:36].strip(),
        line[39:47].strip(),
        line[49:61].strip(),
    )


def _atof(s: str) -> float:
    """C atof semantics: parse a leading float, 0.0 on garbage/empty."""
    s = s.strip()
    if not s:
        return 0.0
    try:
        return float(s)
    except ValueError:
        # trim to the longest valid prefix, like atof
        for end in range(len(s), 0, -1):
            try:
                return float(s[:end])
            except ValueError:
                continue
        return 0.0


def _newstate(line: str) -> int:
    head = line[:3]
    if head == "RHS":
        return _RHS
    if head == "RAN":
        return _RNGS
    if head == "BOU":
        return _BNDS
    if head == "QUA":
        return _QUADS
    if head == "END":
        return _END
    raise ValueError(f"unrecognized section label: {line.strip()}")


def read_mps(path_or_paths, lp: LP | None = None,
             engine: str = "auto") -> LP:
    """Parse one or more MPS files into an LP (reference readlp iolp.c:145).

    engine: "native" uses the C++ reader (vanderbei_tpu_torch/native, built
    with g++ at first use), "python" this implementation, "auto" prefers
    native for single-file reads with default options and reads with
    python where native cannot (vanderbei_tpu's semantics).  Both give the
    same LP; this is a host parser, not a device path.
    """
    if isinstance(path_or_paths, (str,)):
        paths = [path_or_paths]
    else:
        paths = list(path_or_paths)

    if engine in ("auto", "native") and lp is None and len(paths) == 1:
        try:
            from ..native import read_mps_native
            return read_mps_native(paths[0])
        except (OSError, RuntimeError, ValueError):
            # no g++, a failed build or load, or a file the native parser
            # refuses: "auto" reads it with python
            if engine == "native":
                raise

    if lp is None:
        lp = LP()

    name = ""
    obj = lp.obj_name
    rhs_name = lp.rhs_name
    ranges_name = lp.ranges_name
    bounds_name = lp.bounds_name
    maximize = lp.maximize
    sf_req, inftol = lp.sf_req, lp.inftol
    verbose, itnlim, timlim = lp.verbose, lp.itnlim, lp.timlim
    params: dict = dict(lp.params)

    rowlab: list[str] = []
    row_index: dict[str, int] = {}
    row_mark: list[int] = []        # 0 = G/E, 1 = L (negate), 2 = N
    row_r: list[float] = []         # ranges column (inf for L/G, 0 for E)

    collab: list[str] = []
    col_index: dict[str, int] = {}
    col_entries: list[list] = []    # per-column [(row, val)] in arrival order
    varsgn: list[int] = []
    lo: list[float] = []
    up: list[float] = []

    b_by_row: dict[int, float] = {}
    quads: list[list] = []          # per-column [(row, val)] strict lower tri
    diagQ: dict[int, float] = {}

    state = _HEADER
    int_marker = False              # real_int_flg toggling (iolp.c:418-420)
    j_prev = -1                     # QUADS column ordering check

    for path in paths:
        with open(path, "r", errors="replace") as fp:
            for raw in fp:
                if raw.startswith("*"):
                    continue
                line = raw.rstrip("\n")

                if state == _HEADER:
                    toks = line.split()
                    if not toks:
                        continue
                    if toks[0].startswith("NAME"):
                        name = toks[1] if len(toks) > 1 else ""
                        state = _NAME
                        continue
                    key = toks[0]
                    val = toks[1] if len(toks) > 1 else ""
                    params[key] = val
                    if key == "MAX":
                        maximize = True
                    elif key == "MIN":
                        maximize = False
                    elif key == "SIGFIG":
                        sf_req = int(_atof(val))
                    elif key == "INFTOL":
                        inftol = _atof(val)
                    elif key == "OBJ":
                        obj = val
                    elif key == "RHS":
                        rhs_name = val
                    elif key == "RANGES":
                        ranges_name = val
                    elif key == "BOUNDS":
                        bounds_name = val
                    elif key == "VERBOSE":
                        verbose = int(_atof(val))
                    elif key == "ITNLIM":
                        itnlim = int(_atof(val))
                    elif key == "TIMLIM":
                        timlim = _atof(val)
                    continue

                if state == _NAME:
                    if line[:3] == "ROW":
                        state = _ROWS
                    # else: warn and skip (reference warn(20))
                    continue

                if state == _ROWS:
                    if line[:1] != " " and line[:1] != "":
                        if line[:3] == "COL":
                            state = _COLS
                        continue
                    typ, label0, *_ = _fields(line)
                    t = typ[:1] if typ else ""
                    if t == "L":
                        row_r.append(INF)
                        row_mark.append(1)
                    elif t == "E":
                        row_r.append(0.0)
                        row_mark.append(0)
                    elif t == "G":
                        row_r.append(INF)
                        row_mark.append(0)
                    elif t == "N":
                        row_r.append(INF)
                        row_mark.append(2)
                        if obj == "" or (obj and obj in label0):
                            obj = label0
                    else:
                        continue
                    row_index[label0] = len(rowlab)
                    rowlab.append(label0)
                    continue

                if line[:1] != " " and line[:1] != "":
                    state = _newstate(line)
                    continue

                typ, label0, label1, valstr1, label2, valstr2 = _fields(line)

                if state == _COLS:
                    if label1 == "'MARKER'" or label2 == "'MARKER'":
                        # INTORG/INTEND toggle (iolp.c:418-420 flips 1<->2)
                        int_marker = not int_marker
                        continue
                    j = col_index.get(label0)
                    if j is None:
                        j = len(collab)
                        col_index[label0] = j
                        collab.append(label0)
                        col_entries.append([])
                        varsgn.append(VAR_INTEGER if int_marker else VAR_REAL)
                        lo.append(0.0)
                        up.append(INF)
                    for lab, vs in ((label1, valstr1), (label2, valstr2)):
                        if not lab and not vs:
                            continue
                        value = _atof(vs)
                        if value == 0.0:
                            continue
                        i = row_index.get(lab)
                        if i is None:
                            continue  # warn(30)
                        col_entries[j].append((i, value))
                    continue

                if state == _RHS:
                    if rhs_name == "":
                        rhs_name = label0
                    # reference: my_strstr(label0, rhs) substring match
                    if rhs_name not in label0:
                        continue
                    for lab, vs in ((label1, valstr1), (label2, valstr2)):
                        if not lab and not vs:
                            continue
                        value = _atof(vs)
                        if value == 0.0:
                            continue
                        i = row_index.get(lab)
                        if i is None:
                            continue  # warn(31)
                        b_by_row[i] = value
                    continue

                if state == _RNGS:
                    if ranges_name == "":
                        ranges_name = label0
                    if ranges_name not in label0:
                        continue
                    for lab, vs in ((label1, valstr1), (label2, valstr2)):
                        if not lab and not vs:
                            continue
                        value = _atof(vs)
                        if value == 0.0:
                            continue
                        i = row_index.get(lab)
                        if i is None:
                            continue  # warn(32)
                        row_r[i] = value
                    continue

                if state == _BNDS:
                    if bounds_name == "":
                        bounds_name = label0
                    if bounds_name not in label0:
                        continue
                    value = _atof(valstr1)
                    j = col_index.get(label1)
                    if j is None:
                        continue  # warn(33)
                    if typ == "LO":
                        lo[j] = value
                    elif typ == "UP":
                        up[j] = value
                    elif typ == "FX":
                        lo[j] = value
                        up[j] = value
                    elif typ == "FR":
                        lo[j] = -INF
                        up[j] = INF
                    elif typ == "PL":
                        up[j] = INF
                    elif typ == "MI":
                        # quirk preserved: upper becomes the previous lower
                        up[j] = lo[j]
                        lo[j] = -INF
                    elif typ == "BV":
                        lo[j] = 0.0
                        up[j] = 1.0
                        varsgn[j] = VAR_INTEGER
                    elif typ == "LI":
                        lo[j] = value
                        varsgn[j] = VAR_INTEGER
                    elif typ == "UI":
                        up[j] = value
                        varsgn[j] = VAR_INTEGER
                    elif typ == "SC":
                        lo[j] = 0.0
                        up[j] = value
                        varsgn[j] = VAR_SEMICONT
                    # else: warn(27)
                    continue

                if state == _QUADS:
                    j = col_index.get(label0)
                    if j is None:
                        continue  # warn(34)
                    if j > j_prev:
                        j_prev = j
                    elif j < j_prev:
                        raise ValueError("columns out of order in QUADS section")
                    while len(quads) <= j:
                        quads.append([])
                    for lab, vs in ((label1, valstr1), (label2, valstr2)):
                        if not lab and not vs:
                            continue
                        value = _atof(vs)
                        if value == 0.0:
                            continue
                        i = col_index.get(lab)
                        if i is None:
                            continue  # warn(34)
                        if i > j:
                            quads[j].append((i, value))
                        elif i == j:
                            diagQ[j] = value
                        # else: warn(35) — upper-tri entry ignored
                    continue

    if not name:
        raise ValueError("NAME not found")

    n_all = len(collab)
    m_all = len(rowlab)

    # --- objective extraction, N-row removal, L-row negation (iolp.c:670-722)
    obj_row = row_index.get(obj, -1)
    c = np.zeros(n_all, dtype=np.float64)
    new_row_of = np.full(m_all, -1, dtype=np.int64)
    new_rowlab: list[str] = []
    b_list: list[float] = []
    r_list: list[float] = []
    for i in range(m_all):
        if i == obj_row or row_mark[i] == 2:
            continue
        new_row_of[i] = len(new_rowlab)
        new_rowlab.append(rowlab[i])
        bi = b_by_row.get(i, 0.0)
        b_list.append(-bi if row_mark[i] == 1 else bi)
        r_list.append(row_r[i])
    m = len(new_rowlab)

    A_vals: list[float] = []
    iA: list[int] = []
    kA = np.zeros(n_all + 1, dtype=np.int64)
    for j in range(n_all):
        for (i, v) in col_entries[j]:
            if i == obj_row:
                c[j] = v            # last assignment wins, like the reference
            elif row_mark[i] == 2:
                pass                # other N rows dropped
            else:
                A_vals.append(-v if row_mark[i] == 1 else v)
                iA.append(new_row_of[i])
        kA[j + 1] = len(A_vals)

    # --- symmetrize Q (iolp.c:729-794): full symmetric CSC from lower tri
    q_cols: list[list] = [[] for _ in range(n_all)]
    for j in range(min(len(quads), n_all)):
        for (i, v) in quads[j]:
            q_cols[j].append((i, v))
            q_cols[i].append((j, v))
    for j, v in diagQ.items():
        q_cols[j].append((j, v))
    Q_vals: list[float] = []
    iQ: list[int] = []
    kQ = np.zeros(n_all + 1, dtype=np.int64)
    for j in range(n_all):
        for (i, v) in sorted(q_cols[j]):
            iQ.append(i)
            Q_vals.append(v)
        kQ[j + 1] = len(Q_vals)

    lp.name = name
    lp.m = m
    lp.n = n_all
    lp.A = np.asarray(A_vals, dtype=np.float64)
    lp.iA = np.asarray(iA, dtype=np.int64)
    lp.kA = kA
    lp.b = np.asarray(b_list, dtype=np.float64)
    lp.c = c
    lp.f = 0.0
    lp.r = np.asarray(r_list, dtype=np.float64)
    lp.l = np.asarray(lo, dtype=np.float64)
    lp.u = np.asarray(up, dtype=np.float64)
    lp.Q = np.asarray(Q_vals, dtype=np.float64)
    lp.iQ = np.asarray(iQ, dtype=np.int64)
    lp.kQ = kQ
    lp.qnz = len(Q_vals)
    lp.varsgn = np.asarray(varsgn, dtype=np.int64)
    lp.rowlab = new_rowlab
    lp.collab = collab
    lp.maximize = maximize
    lp.inftol = inftol
    lp.sf_req = sf_req
    lp.verbose = verbose
    lp.itnlim = itnlim
    lp.timlim = timlim
    lp.obj_name = obj
    lp.rhs_name = rhs_name
    lp.ranges_name = ranges_name
    lp.bounds_name = bounds_name
    lp.params = params
    return lp
