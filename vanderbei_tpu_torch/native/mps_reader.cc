// Native MPS reader — the framework's hot-path data loader.
//
// Semantics mirror the Python reference implementation in io/mps.py (which
// itself mirrors the reference parser src/common/iolp.c:145-838): fixed
// column fields, header keywords, ROWS/COLUMNS/RHS/RANGES/BOUNDS/QUADS
// sections, integer markers, all ten bound types with the MI quirk,
// objective extraction from the first/OBJ-matching N row, L-row negation,
// N-row removal, and Q symmetrization.  Exposed through a plain C ABI for
// ctypes (no pybind11 in this image).
//
// Build: g++ -O2 -shared -fPIC -o libvmps.so mps_reader.cc

#include <algorithm>
#include <cctype>
#include <cmath>
#include <utility>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

struct Entry { int64_t row; double val; };

std::string strip(const std::string& s) {
  size_t a = s.find_first_not_of(" \t\r\n");
  if (a == std::string::npos) return "";
  size_t b = s.find_last_not_of(" \t\r\n");
  return s.substr(a, b - a + 1);
}

// fixed-column fields (iolp.c:237-245,259-261)
struct Fields {
  std::string type, l0, l1, v1, l2, v2;
};

Fields split_fields(std::string line) {
  if (line.size() < 79) line.resize(79, ' ');
  Fields f;
  f.type = strip(line.substr(1, 2));
  f.l0 = strip(line.substr(4, 8));
  f.l1 = strip(line.substr(14, 8));
  f.v1 = strip(line.substr(24, 12));
  f.l2 = strip(line.substr(39, 8));
  f.v2 = strip(line.substr(49, 12));
  return f;
}

double atof_c(const std::string& s) {
  if (s.empty()) return 0.0;
  return std::atof(s.c_str());   // C atof semantics: 0.0 on garbage
}

}  // namespace

extern "C" {

struct VmpsLP {
  int64_t m, n, nz, qnz;
  double* A;
  int64_t* iA;
  int64_t* kA;        // n+1
  double* b;          // m
  double* r;          // m
  double* c;          // n
  double* l;          // n
  double* u;          // n
  double* Q;
  int64_t* iQ;
  int64_t* kQ;        // n+1
  int64_t* varsgn;    // n
  char* rowlab;       // concatenated, NUL-separated
  int64_t* rowlab_off;  // m+1
  char* collab;
  int64_t* collab_off;  // n+1
  int32_t maximize;
  double inftol;
  int64_t sf_req, verbose, itnlim;
  double timlim;
  char name[256];
  char obj[256];
  char* err;          // non-null on failure
  // generic header parameter store (iolp.c:270-277): np key/value pairs
  int64_t np_;
  char* pkeys;
  int64_t* pkeys_off;   // np+1
  char* pvals;
  int64_t* pvals_off;   // np+1
};

void vmps_release(VmpsLP* lp) {
  if (!lp) return;
  std::free(lp->A); std::free(lp->iA); std::free(lp->kA);
  std::free(lp->b); std::free(lp->r); std::free(lp->c);
  std::free(lp->l); std::free(lp->u);
  std::free(lp->Q); std::free(lp->iQ); std::free(lp->kQ);
  std::free(lp->varsgn);
  std::free(lp->rowlab); std::free(lp->rowlab_off);
  std::free(lp->collab); std::free(lp->collab_off);
  std::free(lp->pkeys); std::free(lp->pkeys_off);
  std::free(lp->pvals); std::free(lp->pvals_off);
  std::free(lp->err);
  std::free(lp);
}

VmpsLP* vmps_read(const char* path) {
  auto* out = static_cast<VmpsLP*>(std::calloc(1, sizeof(VmpsLP)));
  auto fail = [&](const std::string& msg) {
    out->err = strdup(msg.c_str());
    return out;
  };

  FILE* fp = std::fopen(path, "r");
  if (!fp) return fail(std::string("cannot open file ") + path);

  enum State { HEADER, NAME, ROWS, COLS, RHS, RNGS, BNDS, QUADS, END };
  State state = HEADER;

  std::string name, obj, rhs_name, ranges_name, bounds_name;
  std::vector<std::string> pkeys, pvals;
  bool maximize = false;
  int64_t sf_req = 8, verbose = 2, itnlim = 200;
  double inftol = 1.0e-5, timlim = kInf;

  std::vector<std::string> rowlab;
  std::unordered_map<std::string, int64_t> row_index;
  std::vector<int> row_mark;       // 0 G/E, 1 L, 2 N
  std::vector<double> row_r;

  std::vector<std::string> collab;
  std::unordered_map<std::string, int64_t> col_index;
  std::vector<std::vector<Entry>> col_entries;
  std::vector<int64_t> varsgn;
  std::vector<double> lo, up;

  std::unordered_map<int64_t, double> b_by_row;
  std::vector<std::vector<Entry>> quads;  // strict lower triangle per col
  std::unordered_map<int64_t, double> diagQ;
  bool int_marker = false;
  int64_t j_prev = -1;

  char buf[512];
  while (std::fgets(buf, sizeof(buf), fp)) {
    if (buf[0] == '*') continue;
    std::string line(buf);
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.pop_back();

    if (state == HEADER) {
      std::string t = strip(line);
      if (t.empty()) continue;
      size_t sp = t.find_first_of(" \t");
      std::string key = sp == std::string::npos ? t : t.substr(0, sp);
      std::string val = sp == std::string::npos
          ? "" : strip(t.substr(sp));
      if (key.rfind("NAME", 0) == 0) {
        // first token only, like the reference's sscanf %s%s (iolp.c:265-267)
        size_t vs = val.find_first_of(" \t");
        name = vs == std::string::npos ? val : val.substr(0, vs);
        state = NAME;
        continue;
      }
      {
        // store first token of the value, like the reference's sscanf %s%s
        size_t vs = val.find_first_of(" \t");
        pkeys.push_back(key);
        pvals.push_back(vs == std::string::npos ? val : val.substr(0, vs));
      }
      if (key == "MAX") maximize = true;
      else if (key == "MIN") maximize = false;
      else if (key == "SIGFIG") sf_req = std::atoll(val.c_str());
      else if (key == "INFTOL") inftol = atof_c(val);
      else if (key == "OBJ") obj = val;
      else if (key == "RHS") rhs_name = val;
      else if (key == "RANGES") ranges_name = val;
      else if (key == "BOUNDS") bounds_name = val;
      else if (key == "VERBOSE") verbose = std::atoll(val.c_str());
      else if (key == "ITNLIM") itnlim = std::atoll(val.c_str());
      else if (key == "TIMLIM") timlim = atof_c(val);
      continue;
    }

    if (state == NAME) {
      if (line.compare(0, 3, "ROW") == 0) state = ROWS;
      continue;
    }

    if (state == ROWS) {
      if (!line.empty() && line[0] != ' ') {
        if (line.compare(0, 3, "COL") == 0) state = COLS;
        continue;
      }
      Fields f = split_fields(line);
      char t = f.type.empty() ? '\0' : f.type[0];
      if (t == 'L') { row_r.push_back(kInf); row_mark.push_back(1); }
      else if (t == 'E') { row_r.push_back(0.0); row_mark.push_back(0); }
      else if (t == 'G') { row_r.push_back(kInf); row_mark.push_back(0); }
      else if (t == 'N') {
        row_r.push_back(kInf); row_mark.push_back(2);
        if (obj.empty() || f.l0.find(obj) != std::string::npos) obj = f.l0;
      } else continue;
      row_index[f.l0] = static_cast<int64_t>(rowlab.size());
      rowlab.push_back(f.l0);
      continue;
    }

    if (!line.empty() && line[0] != ' ') {
      std::string head = line.substr(0, 3);
      if (head == "RHS") state = RHS;
      else if (head == "RAN") state = RNGS;
      else if (head == "BOU") state = BNDS;
      else if (head == "QUA") state = QUADS;
      else if (head == "END") state = END;
      else { std::fclose(fp); return fail("unrecognized section: " + line); }
      continue;
    }

    Fields f = split_fields(line);

    switch (state) {
      case COLS: {
        if (f.l1 == "'MARKER'" || f.l2 == "'MARKER'") {
          int_marker = !int_marker;
          break;
        }
        int64_t j;
        auto it = col_index.find(f.l0);
        if (it == col_index.end()) {
          j = static_cast<int64_t>(collab.size());
          col_index[f.l0] = j;
          collab.push_back(f.l0);
          col_entries.emplace_back();
          varsgn.push_back(int_marker ? 2 : 1);
          lo.push_back(0.0);
          up.push_back(kInf);
        } else {
          j = it->second;
        }
        for (auto& [lab, vs] : {std::pair(f.l1, f.v1), std::pair(f.l2, f.v2)}) {
          if (lab.empty() && vs.empty()) continue;
          double v = atof_c(vs);
          if (v == 0.0) continue;
          auto ri = row_index.find(lab);
          if (ri == row_index.end()) continue;   // warn(30)
          col_entries[j].push_back({ri->second, v});
        }
        break;
      }
      case RHS: {
        if (rhs_name.empty()) rhs_name = f.l0;
        if (f.l0.find(rhs_name) == std::string::npos) break;
        for (auto& [lab, vs] : {std::pair(f.l1, f.v1), std::pair(f.l2, f.v2)}) {
          if (lab.empty() && vs.empty()) continue;
          double v = atof_c(vs);
          if (v == 0.0) continue;
          auto ri = row_index.find(lab);
          if (ri == row_index.end()) continue;
          b_by_row[ri->second] = v;
        }
        break;
      }
      case RNGS: {
        if (ranges_name.empty()) ranges_name = f.l0;
        if (f.l0.find(ranges_name) == std::string::npos) break;
        for (auto& [lab, vs] : {std::pair(f.l1, f.v1), std::pair(f.l2, f.v2)}) {
          if (lab.empty() && vs.empty()) continue;
          double v = atof_c(vs);
          if (v == 0.0) continue;
          auto ri = row_index.find(lab);
          if (ri == row_index.end()) continue;
          row_r[ri->second] = v;
        }
        break;
      }
      case BNDS: {
        if (bounds_name.empty()) bounds_name = f.l0;
        if (f.l0.find(bounds_name) == std::string::npos) break;
        double v = atof_c(f.v1);
        auto ci = col_index.find(f.l1);
        if (ci == col_index.end()) break;       // warn(33)
        int64_t j = ci->second;
        const std::string& t = f.type;
        if (t == "LO") lo[j] = v;
        else if (t == "UP") up[j] = v;
        else if (t == "FX") { lo[j] = v; up[j] = v; }
        else if (t == "FR") { lo[j] = -kInf; up[j] = kInf; }
        else if (t == "PL") up[j] = kInf;
        else if (t == "MI") { up[j] = lo[j]; lo[j] = -kInf; }  // quirk kept
        else if (t == "BV") { lo[j] = 0.0; up[j] = 1.0; varsgn[j] = 2; }
        else if (t == "LI") { lo[j] = v; varsgn[j] = 2; }
        else if (t == "UI") { up[j] = v; varsgn[j] = 2; }
        else if (t == "SC") { lo[j] = 0.0; up[j] = v; varsgn[j] = 3; }
        break;
      }
      case QUADS: {
        auto ci = col_index.find(f.l0);
        if (ci == col_index.end()) break;       // warn(34)
        int64_t j = ci->second;
        if (j > j_prev) j_prev = j;
        else if (j < j_prev) {
          std::fclose(fp);
          return fail("columns out of order in QUADS section");
        }
        if (quads.size() <= static_cast<size_t>(j)) quads.resize(j + 1);
        for (auto& [lab, vs] : {std::pair(f.l1, f.v1), std::pair(f.l2, f.v2)}) {
          if (lab.empty() && vs.empty()) continue;
          double v = atof_c(vs);
          if (v == 0.0) continue;
          auto ii = col_index.find(lab);
          if (ii == col_index.end()) continue;
          int64_t i = ii->second;
          if (i > j) quads[j].push_back({i, v});
          else if (i == j) diagQ[j] = v;
          // else: upper-triangle entry ignored (warn 35)
        }
        break;
      }
      default:
        break;
    }
  }
  std::fclose(fp);
  if (name.empty()) return fail("NAME not found");

  const int64_t n = static_cast<int64_t>(collab.size());
  const int64_t m_all = static_cast<int64_t>(rowlab.size());

  // objective extraction, N-row removal, L-row negation (iolp.c:670-722)
  int64_t obj_row = -1;
  {
    auto it = row_index.find(obj);
    if (it != row_index.end()) obj_row = it->second;
  }
  std::vector<int64_t> new_row_of(m_all, -1);
  std::vector<std::string> new_rowlab;
  std::vector<double> bvec, rvec;
  for (int64_t i = 0; i < m_all; ++i) {
    if (i == obj_row || row_mark[i] == 2) continue;
    new_row_of[i] = static_cast<int64_t>(new_rowlab.size());
    new_rowlab.push_back(rowlab[i]);
    double bi = 0.0;
    auto bit = b_by_row.find(i);
    if (bit != b_by_row.end()) bi = bit->second;
    bvec.push_back(row_mark[i] == 1 ? -bi : bi);
    rvec.push_back(row_r[i]);
  }
  const int64_t m = static_cast<int64_t>(new_rowlab.size());

  std::vector<double> Avals;
  std::vector<int64_t> iA;
  std::vector<int64_t> kA(n + 1, 0);
  std::vector<double> c(n, 0.0);
  for (int64_t j = 0; j < n; ++j) {
    for (const Entry& e : col_entries[j]) {
      if (e.row == obj_row) c[j] = e.val;          // last wins
      else if (row_mark[e.row] == 2) continue;
      else {
        Avals.push_back(row_mark[e.row] == 1 ? -e.val : e.val);
        iA.push_back(new_row_of[e.row]);
      }
    }
    kA[j + 1] = static_cast<int64_t>(Avals.size());
  }

  // symmetrize Q
  std::vector<std::vector<Entry>> qcols(n);
  for (size_t j = 0; j < quads.size(); ++j) {
    for (const Entry& e : quads[j]) {
      qcols[j].push_back({e.row, e.val});
      qcols[e.row].push_back({static_cast<int64_t>(j), e.val});
    }
  }
  for (auto& [j, v] : diagQ) qcols[j].push_back({j, v});
  std::vector<double> Qvals;
  std::vector<int64_t> iQ;
  std::vector<int64_t> kQ(n + 1, 0);
  for (int64_t j = 0; j < n; ++j) {
    auto& colq = qcols[j];
    std::sort(colq.begin(), colq.end(),
              [](const Entry& a, const Entry& b) { return a.row < b.row; });
    for (const Entry& e : colq) { iQ.push_back(e.row); Qvals.push_back(e.val); }
    kQ[j + 1] = static_cast<int64_t>(Qvals.size());
  }

  // ---- marshal into the C ABI struct
  auto dupd = [](const std::vector<double>& v) {
    auto* p = static_cast<double*>(std::malloc(sizeof(double) * std::max<size_t>(1, v.size())));
    std::memcpy(p, v.data(), sizeof(double) * v.size());
    return p;
  };
  auto dupi = [](const std::vector<int64_t>& v) {
    auto* p = static_cast<int64_t*>(std::malloc(sizeof(int64_t) * std::max<size_t>(1, v.size())));
    std::memcpy(p, v.data(), sizeof(int64_t) * v.size());
    return p;
  };
  auto dup_labels = [](const std::vector<std::string>& labs,
                       char** text, int64_t** offs) {
    size_t total = 0;
    for (auto& s : labs) total += s.size() + 1;
    *text = static_cast<char*>(std::malloc(std::max<size_t>(1, total)));
    *offs = static_cast<int64_t*>(std::malloc(sizeof(int64_t) * (labs.size() + 1)));
    size_t pos = 0;
    for (size_t i = 0; i < labs.size(); ++i) {
      (*offs)[i] = static_cast<int64_t>(pos);
      std::memcpy(*text + pos, labs[i].c_str(), labs[i].size() + 1);
      pos += labs[i].size() + 1;
    }
    (*offs)[labs.size()] = static_cast<int64_t>(pos);
  };

  out->m = m;
  out->n = n;
  out->nz = static_cast<int64_t>(Avals.size());
  out->qnz = static_cast<int64_t>(Qvals.size());
  out->A = dupd(Avals);
  out->iA = dupi(iA);
  out->kA = dupi(kA);
  out->b = dupd(bvec);
  out->r = dupd(rvec);
  out->c = dupd(c);
  out->l = dupd(lo);
  out->u = dupd(up);
  out->Q = dupd(Qvals);
  out->iQ = dupi(iQ);
  out->kQ = dupi(kQ);
  out->varsgn = dupi(varsgn);
  dup_labels(new_rowlab, &out->rowlab, &out->rowlab_off);
  dup_labels(collab, &out->collab, &out->collab_off);
  out->maximize = maximize ? 1 : 0;
  out->inftol = inftol;
  out->sf_req = sf_req;
  out->verbose = verbose;
  out->itnlim = itnlim;
  out->timlim = timlim;
  std::snprintf(out->name, sizeof(out->name), "%s", name.c_str());
  std::snprintf(out->obj, sizeof(out->obj), "%s", obj.c_str());
  out->np_ = static_cast<int64_t>(pkeys.size());
  dup_labels(pkeys, &out->pkeys, &out->pkeys_off);
  dup_labels(pvals, &out->pvals, &out->pvals_off);
  return out;
}

}  // extern "C"
