"""Canonical netlib optimal values, a copy of vanderbei_tpu/io/netlib_golden.py
(tests/test_torch_evaluate.py holds the two tables equal).

Extracted from the published table of the netlib corpus (its README);
the golden oracle of the corpus sweep (evaluate.py).

Each entry: name -> (mps filename, rows, cols, nonzeros, bound/range flags,
optimal value).
"""

NETLIB_GOLDEN = {
    '25FV47': ('25fv47.mps', 822, 1571, 11127, '', 5501.8458883),
    '80BAU3B': ('80bau3b.mps', 2263, 9799, 29063, 'B', 987232.16072),
    'ADLITTLE': ('adlittle.mps', 57, 97, 465, '', 225494.96316),
    'AFIRO': ('afiro.mps', 28, 32, 88, '', -464.75314286),
    'AGG': ('agg.mps', 489, 163, 2541, '', -35991767.287),
    'AGG2': ('agg2.mps', 517, 302, 4515, '', -20239252.356),
    'AGG3': ('agg3.mps', 517, 302, 4531, '', 10312115.935),
    'BANDM': ('bandm.mps', 306, 472, 2659, '', -158.62801845),
    'BEACONFD': ('beaconfd.mps', 174, 262, 3476, '', 33592.485807),
    'BLEND': ('blend.mps', 75, 83, 521, '', -30.812149846),
    'BNL1': ('bnl1.mps', 644, 1175, 6129, '', 1977.6292856),
    'BNL2': ('bnl2.mps', 2325, 3489, 16124, '', 1811.2365404),
    'BOEING1': ('boeing1.mps', 351, 384, 3865, 'BR', -335.21356751),
    'BOEING2': ('boeing2.mps', 167, 143, 1339, 'BR', -315.01872802),
    'BORE3D': ('bore3d.mps', 234, 315, 1525, 'B', 1373.0803942),
    'BRANDY': ('brandy.mps', 221, 249, 2150, '', 1518.5098965),
    'CAPRI': ('capri.mps', 272, 353, 1786, 'B', 2690.0129138),
    'CYCLE': ('cycle.mps', 1904, 2857, 21322, 'B', -5.2263930249),
    'CZPROB': ('czprob.mps', 930, 3523, 14173, 'B', 2185196.6989),
    'D2Q06C': ('d2q06c.mps', 2172, 5167, 35674, '', 122784.23615),
    'D6CUBE': ('d6cube.mps', 416, 6184, 43888, 'B', 315.49166667),
    'DEGEN2': ('degen2.mps', 445, 534, 4449, '', -1435.178),
    'DEGEN3': ('degen3.mps', 1504, 1818, 26230, '', -987.294),
    'DFL001': ('dfl001.mps', 6072, 12230, 41873, 'B', 11266400.0),
    'E226': ('e226.mps', 224, 282, 2767, '', -18.751929066),
    'ETAMACRO': ('etamacro.mps', 401, 688, 2489, 'B', -755.71521774),
    'FFFFF800': ('fffff800.mps', 525, 854, 6235, '', 555679.61165),
    'FINNIS': ('finnis.mps', 498, 614, 2714, 'B', 172790.96547),
    'FIT1D': ('fit1d.mps', 25, 1026, 14430, 'B', -9146.3780924),
    'FIT1P': ('fit1p.mps', 628, 1677, 10894, 'B', 9146.3780924),
    'FIT2D': ('fit2d.mps', 26, 10500, 138018, 'B', -68464.293294),
    'FIT2P': ('fit2p.mps', 3001, 13525, 60784, 'B', 68464.293232),
    'FORPLAN': ('forplan.mps', 162, 421, 4916, 'BR', -664.21873953),
    'GANGES': ('ganges.mps', 1310, 1681, 7021, 'B', -109586.36356),
    'GFRD-PNC': ('gfrd-pnc.mps', 617, 1092, 3467, 'B', 6902235.9995),
    'GREENBEA': ('greenbea.mps', 2393, 5405, 31499, 'B', -72462405.908),
    'GREENBEB': ('greenbeb.mps', 2393, 5405, 31499, 'B', -4302147.6065),
    'GROW15': ('grow15.mps', 301, 645, 5665, 'B', -106870941.29),
    'GROW22': ('grow22.mps', 441, 946, 8318, 'B', -160834336.48),
    'GROW7': ('grow7.mps', 141, 301, 2633, 'B', -47787811.815),
    'ISRAEL': ('israel.mps', 175, 142, 2358, '', -896644.82186),
    'KB2': ('kb2.mps', 44, 41, 291, 'B', -1749.9001299),
    'LOTFI': ('lotfi.mps', 154, 308, 1086, '', -25.264706062),
    'MAROS': ('maros.mps', 847, 1443, 10006, 'B', -58063.743701),
    'MAROS-R7': ('maros-r7.mps', 3137, 9408, 151120, '', 1497185.1665),
    'MODSZK1': ('modszk1.mps', 688, 1620, 4158, 'B', 320.61972906),
    'NESM': ('nesm.mps', 663, 2923, 13988, 'BR', 14076073.035),
    'PEROLD': ('perold.mps', 626, 1376, 6026, 'B', -9380.7580773),
    'PILOT': ('pilot.mps', 1442, 3652, 43220, 'B', -557.40430007),
    'PILOT.JA': ('pilot.ja.mps', 941, 1988, 14706, 'B', -6113.1344111),
    'PILOT.WE': ('pilot.we.mps', 723, 2789, 9218, 'B', -2720102.7439),
    'PILOT4': ('pilot4.mps', 411, 1000, 5145, 'B', -2581.1392641),
    'PILOT87': ('pilot87.mps', 2031, 4883, 73804, 'B', 301.71072827),
    'PILOTNOV': ('pilotnov.mps', 976, 2172, 13129, 'B', -4497.2761882),
    'QAP8': ('qap8.mps', 913, 1632, 8304, '', 203.5),
    'QAP12': ('qap12.mps', 3193, 8856, 44244, '', 522.89435056),
    'QAP15': ('qap15.mps', 6331, 22275, 110700, '', 1040.994041),
    'RECIPE': ('recipe.mps', 92, 180, 752, 'B', -266.616),
    'SC105': ('sc105.mps', 106, 103, 281, '', -52.202061212),
    'SC205': ('sc205.mps', 206, 203, 552, '', -52.202061212),
    'SC50A': ('sc50a.mps', 51, 48, 131, '', -64.575077059),
    'SC50B': ('sc50b.mps', 51, 48, 119, '', -70.0),
    'SCAGR25': ('scagr25.mps', 472, 500, 2029, '', -14753433.061),
    'SCAGR7': ('scagr7.mps', 130, 140, 553, '', -2331389.2548),
    'SCFXM1': ('scfxm1.mps', 331, 457, 2612, '', 18416.759028),
    'SCFXM2': ('scfxm2.mps', 661, 914, 5229, '', 36660.261565),
    'SCFXM3': ('scfxm3.mps', 991, 1371, 7846, '', 54901.25455),
    'SCORPION': ('scorpion.mps', 389, 358, 1708, '', 1878.1248227),
    'SCRS8': ('scrs8.mps', 491, 1169, 4029, '', 904.29998619),
    'SCSD1': ('scsd1.mps', 78, 760, 3148, '', 8.6666666743),
    'SCSD6': ('scsd6.mps', 148, 1350, 5666, '', 50.500000078),
    'SCSD8': ('scsd8.mps', 398, 2750, 11334, '', 904.99999993),
    'SCTAP1': ('sctap1.mps', 301, 480, 2052, '', 1412.25),
    'SCTAP2': ('sctap2.mps', 1091, 1880, 8124, '', 1724.8071429),
    'SCTAP3': ('sctap3.mps', 1481, 2480, 10734, '', 1424.0),
    'SEBA': ('seba.mps', 516, 1028, 4874, 'BR', 15711.6),
    'SHARE1B': ('share1b.mps', 118, 225, 1182, '', -76589.318579),
    'SHARE2B': ('share2b.mps', 97, 79, 730, '', -415.73224074),
    'SHELL': ('shell.mps', 537, 1775, 4900, 'B', 1208825346.0),
    'SHIP04L': ('ship04l.mps', 403, 2118, 8450, '', 1793324.538),
    'SHIP04S': ('ship04s.mps', 403, 1458, 5810, '', 1798714.7004),
    'SHIP08L': ('ship08l.mps', 779, 4283, 17085, '', 1909055.2114),
    'SHIP08S': ('ship08s.mps', 779, 2387, 9501, '', 1920098.2105),
    'SHIP12L': ('ship12l.mps', 1152, 5427, 21597, '', 1470187.9193),
    'SHIP12S': ('ship12s.mps', 1152, 2763, 10941, '', 1489236.1344),
    'SIERRA': ('sierra.mps', 1228, 2036, 9252, 'B', 15394362.184),
    'STAIR': ('stair.mps', 357, 467, 3857, 'B', -251.26695119),
    'STANDATA': ('standata.mps', 360, 1075, 3038, 'B', 1257.6995),
    'STANDMPS': ('standmps.mps', 468, 1075, 3686, 'B', 1406.0175),
    'STOCFOR1': ('stocfor1.mps', 118, 111, 474, '', -41131.976219),
    'STOCFOR2': ('stocfor2.mps', 2158, 2031, 9492, '', -39024.408538),
    'STOCFOR3': ('stocfor3.mps', 16676, 15695, 74004, '', -39976.661576),
    'TRUSS': ('truss.mps', 1001, 8806, 36642, '', 458815.84719),
    'TUFF': ('tuff.mps', 334, 587, 4523, 'B', 0.29214776509),
    'VTP.BASE': ('vtp.base.mps', 199, 203, 914, 'B', 129831.46246),
    'WOOD1P': ('wood1p.mps', 245, 2594, 70216, '', 1.4429024116),
    'WOODW': ('woodw.mps', 1099, 8405, 37478, '', 1.3044763331),
    # --- kennington-set instances present on disk but absent from the
    # published table (problems/netlib/README.md); dims from the
    # reference's evaluate tables, optima from the published kennington
    # collection (netlib lp/data/kennington) ---
    'CRE-A': ('cre-a.mps', 3516, 4067, 14987, '', 2.3595407061e+07),
    'CRE-C': ('cre-c.mps', 3068, 3678, 13244, '', 2.5275116141e+07),
    'KEN-07': ('ken-07.mps', 2426, 3602, 8404, 'B', -6.7952044338e+08),
    'KEN-11': ('ken-11.mps', 14694, 21349, 49058, 'B', -6.9723822625e+09),
    'PDS-02': ('pds-02.mps', 2953, 7535, 16390, 'B', 2.8857862010e+10),
    'PDS-06': ('pds-06.mps', 9881, 28655, 62524, 'B', 2.7761037600e+10),
    # STANDGUB = STANDATA plus GUB marker rows; same optimum ("see NOTES"
    # in the published table; the reference binaries solve it to this)
    'STANDGUB': ('standgub.mps', 362, 1184, 3147, 'B', 1257.6995),
}

# On-disk file revisions whose true optimum differs from the published
# table value (netlib files were revised over the years; the reference's
# own binaries land on these too), as verified with an independent solver
# (scipy HiGHS) on the corpus's MPS files.
ONDISK_OVERRIDES = {
    'PILOT': -557.4897292796655,     # table: -5.5740430007E+02 (stale);
                                     # reference ipo stalls at iterlim on
                                     # the same -557.48960 point
}
