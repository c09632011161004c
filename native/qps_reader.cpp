// Native QPS/MPS reader for qpalm_jax.
//
// C++ equivalent of the reference's two-pass C parser
// (reference: interfaces/qps/src/qpalm_qps.c:71-540, index_hash.c), exposed
// through a plain C ABI consumed from Python via ctypes
// (qpalm_jax/io/native.py).  Semantics match qpalm_jax/io/qps.py exactly —
// the Python parser is the fallback and the differential-test oracle.
//
// Build: see native/Makefile (g++ -O2 -shared -fPIC).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr double kInfty = 1e20;  // QPALM_INFTY convention

double clip_inf(double v) {
    if (v > kInfty) return kInfty;
    if (v < -kInfty) return -kInfty;
    return v;
}

struct Triplet {
    int64_t r, c;
    double v;
};

struct Problem {
    std::string name;
    int64_t n = 0, m = 0;
    std::vector<Triplet> A, Q;
    std::vector<double> q, bmin, bmax;
    double c = 0.0;
    std::string error;
};

std::vector<std::string> tokens(const std::string& line) {
    std::vector<std::string> out;
    std::istringstream ss(line);
    std::string t;
    while (ss >> t) out.push_back(t);
    return out;
}

std::string upper(std::string s) {
    for (auto& ch : s) ch = (char)std::toupper((unsigned char)ch);
    return s;
}

struct Sections {
    std::string name;
    std::unordered_map<std::string, std::vector<std::string>> lines;
    std::vector<std::string> order;
};

bool split_sections(const std::string& path, Sections& secs, std::string& err) {
    std::ifstream f(path);
    if (!f) {
        err = "could not open file " + path;
        return false;
    }
    std::string raw;
    std::string current;
    while (std::getline(f, raw)) {
        if (!raw.empty() && raw.back() == '\r') raw.pop_back();
        // skip blank/comment lines
        size_t first = raw.find_first_not_of(" \t");
        if (first == std::string::npos) continue;
        if (raw[first] == '*' || raw[first] == '#') continue;
        if (first == 0) {  // section header
            auto toks = tokens(raw);
            std::string head = upper(toks[0]);
            if (head == "NAME") {
                secs.name = toks.size() > 1 ? toks[1] : "";
                continue;
            }
            if (head == "ENDATA") break;
            current = head;
            secs.order.push_back(head);
            secs.lines.emplace(head, std::vector<std::string>{});
        } else if (!current.empty()) {
            secs.lines[current].push_back(raw);
        }
    }
    return true;
}

bool parse(const std::string& path, Problem& p) {
    Sections secs;
    if (!split_sections(path, secs, p.error)) return false;
    p.name = secs.name;

    auto get = [&](const char* k) -> const std::vector<std::string>& {
        static const std::vector<std::string> empty;
        auto it = secs.lines.find(k);
        return it == secs.lines.end() ? empty : it->second;
    };

    // ---- ROWS ----
    std::string objective;
    std::vector<std::string> row_names;
    std::unordered_map<std::string, int64_t> row_idx;
    std::unordered_map<std::string, char> row_sign;
    for (const auto& line : get("ROWS")) {
        auto t = tokens(line);
        if (t.size() != 2) {
            p.error = "ROWS line not in new QPS format: " + line;
            return false;
        }
        std::string sense = upper(t[0]);
        if (sense == "N") {
            if (objective.empty()) objective = t[1];
            continue;
        }
        if (sense != "L" && sense != "G" && sense != "E") {
            p.error = "unknown row sense " + sense;
            return false;
        }
        row_sign[t[1]] = sense[0];
        row_idx[t[1]] = (int64_t)row_names.size();
        row_names.push_back(t[1]);
    }
    int64_t m_rows = (int64_t)row_names.size();

    // ---- COLUMNS ----
    std::vector<std::string> col_names;
    std::unordered_map<std::string, int64_t> col_idx;
    std::unordered_map<int64_t, double> q_entries;
    for (const auto& line : get("COLUMNS")) {
        auto t = tokens(line);
        if (t.size() >= 3 && upper(t[1]) == "'MARKER'") {
            p.error = "integer MARKER sections are not supported";
            return false;
        }
        auto it = col_idx.find(t[0]);
        int64_t j;
        if (it == col_idx.end()) {
            j = (int64_t)col_names.size();
            col_idx[t[0]] = j;
            col_names.push_back(t[0]);
        } else {
            j = it->second;
        }
        if ((t.size() - 1) % 2) {
            p.error = "malformed COLUMNS line: " + line;
            return false;
        }
        for (size_t k = 1; k + 1 < t.size(); k += 2) {
            const std::string& rname = t[k];
            double val = clip_inf(std::stod(t[k + 1]));
            if (rname == objective) {
                q_entries[j] = val;
            } else {
                auto rit = row_idx.find(rname);
                if (rit == row_idx.end()) {
                    p.error = "unknown row " + rname + " in COLUMNS";
                    return false;
                }
                p.A.push_back({rit->second, j, val});
            }
        }
    }
    int64_t n = (int64_t)col_names.size();

    // ---- BOUNDS pass 1: unnamed detection + FR set ----
    const auto& bounds_lines = get("BOUNDS");
    bool no_name_bounds = false;
    for (const auto& line : bounds_lines) {
        auto t = tokens(line);
        std::string bt = upper(t[0]);
        bool no_val = (bt == "FR" || bt == "MI" || bt == "PL" || bt == "BV");
        if (no_val) {
            if (t.size() == 2) no_name_bounds = true;
        } else {
            if (t.size() == 3) no_name_bounds = true;
        }
    }
    auto bound_col_val = [&](const std::vector<std::string>& t,
                             std::string& cname, double& val) {
        std::string bt = upper(t[0]);
        bool has_val = !(bt == "FR" || bt == "MI" || bt == "PL" || bt == "BV");
        if (no_name_bounds) {
            cname = t[1];
            val = (has_val && t.size() > 2) ? std::stod(t[2]) : 0.0;
        } else {
            cname = t.size() > 2 ? t[2] : t[1];
            val = (has_val && t.size() > 3) ? std::stod(t[3]) : 0.0;
        }
    };
    std::unordered_set<int64_t> free_cols;
    for (const auto& line : bounds_lines) {
        auto t = tokens(line);
        if (upper(t[0]) == "FR") {
            std::string cname;
            double val;
            bound_col_val(t, cname, val);
            free_cols.insert(col_idx.at(cname));
        }
    }
    std::vector<int64_t> bounded_cols;
    std::unordered_map<int64_t, int64_t> bound_row;
    for (int64_t j = 0; j < n; ++j) {
        if (!free_cols.count(j)) {
            bound_row[j] = m_rows + (int64_t)bounded_cols.size();
            bounded_cols.push_back(j);
        }
    }
    int64_t m = m_rows + (int64_t)bounded_cols.size();

    // ---- default bounds ----
    p.bmin.assign((size_t)m, 0.0);
    p.bmax.assign((size_t)m, 0.0);
    for (const auto& rn : row_names) {
        int64_t i = row_idx[rn];
        switch (row_sign[rn]) {
            case 'L': p.bmin[i] = -kInfty; p.bmax[i] = 0.0; break;
            case 'G': p.bmin[i] = 0.0; p.bmax[i] = kInfty; break;
            default:  p.bmin[i] = 0.0; p.bmax[i] = 0.0; break;
        }
    }
    for (int64_t j : bounded_cols) {
        p.bmin[bound_row[j]] = 0.0;
        p.bmax[bound_row[j]] = kInfty;
        p.A.push_back({bound_row[j], j, 1.0});
    }

    // ---- RHS ----
    const auto& rhs_lines = get("RHS");
    bool no_name_rhs = false;
    for (const auto& line : rhs_lines) {
        size_t k = tokens(line).size();
        if (k == 2 || k == 4) no_name_rhs = true;
    }
    auto apply_rhs = [&](const std::string& rname, double val) -> bool {
        if (rname == objective) {
            p.c = -val;
            return true;
        }
        auto it = row_idx.find(rname);
        if (it == row_idx.end()) {
            p.error = "unknown row " + rname + " in RHS";
            return false;
        }
        int64_t i = it->second;
        switch (row_sign[rname]) {
            case 'L': p.bmax[i] = val; p.bmin[i] = -kInfty; break;
            case 'G': p.bmin[i] = val; break;
            default:  p.bmin[i] = val; p.bmax[i] = val; break;
        }
        return true;
    };
    for (const auto& line : rhs_lines) {
        auto t = tokens(line);
        size_t start = no_name_rhs ? 0 : 1;
        for (size_t k = start; k + 1 < t.size(); k += 2)
            if (!apply_rhs(t[k], std::stod(t[k + 1]))) return false;
    }

    // ---- RANGES ----
    for (const auto& line : get("RANGES")) {
        auto t = tokens(line);
        for (size_t k = 1; k + 1 < t.size(); k += 2) {
            auto it = row_idx.find(t[k]);
            if (it == row_idx.end()) {
                p.error = "unknown row " + t[k] + " in RANGES";
                return false;
            }
            int64_t i = it->second;
            double r = std::stod(t[k + 1]);
            switch (row_sign[t[k]]) {
                case 'L': p.bmin[i] = p.bmax[i] - std::fabs(r); break;
                case 'G': p.bmax[i] = p.bmin[i] + std::fabs(r); break;
                default:
                    if (r >= 0) p.bmax[i] = p.bmin[i] + r;
                    else        p.bmin[i] = p.bmax[i] + r;
            }
        }
    }

    // ---- BOUNDS pass 2 ----
    for (const auto& line : bounds_lines) {
        auto t = tokens(line);
        std::string bt = upper(t[0]);
        std::string cname;
        double val;
        bound_col_val(t, cname, val);
        auto cit = col_idx.find(cname);
        if (cit == col_idx.end()) {
            p.error = "unknown column " + cname + " in BOUNDS";
            return false;
        }
        int64_t j = cit->second;
        if (bt == "FR") continue;
        int64_t i = bound_row.at(j);
        if (bt == "UP") p.bmax[i] = val;
        else if (bt == "LO") p.bmin[i] = val;
        else if (bt == "FX") { p.bmin[i] = val; p.bmax[i] = val; }
        else if (bt == "MI") p.bmin[i] = -kInfty;
        else if (bt == "PL") p.bmax[i] = kInfty;
        else if (bt == "BV") { p.bmin[i] = 0.0; p.bmax[i] = 1.0; }
        else {
            p.error = "unknown bound type " + bt;
            return false;
        }
    }

    // ---- QUADOBJ / QMATRIX ----
    bool qmatrix = secs.lines.count("QMATRIX") && !secs.lines.count("QUADOBJ");
    const auto& quad = secs.lines.count("QUADOBJ") ? get("QUADOBJ")
                                                   : get("QMATRIX");
    for (const auto& line : quad) {
        auto t = tokens(line);
        if (t.size() < 3) {
            p.error = "malformed quadratic line: " + line;
            return false;
        }
        auto c1 = col_idx.find(t[0]);
        auto c2 = col_idx.find(t[1]);
        if (c1 == col_idx.end() || c2 == col_idx.end()) {
            p.error = "unknown column in quadratic section: " + line;
            return false;
        }
        int64_t cj = c1->second, ri = c2->second;
        double val = clip_inf(std::stod(t[2]));
        p.Q.push_back({ri, cj, val});
        if (ri != cj && !qmatrix) p.Q.push_back({cj, ri, val});
    }

    p.q.assign((size_t)n, 0.0);
    for (auto& [j, val] : q_entries) p.q[(size_t)j] = val;
    p.n = n;
    p.m = m;
    return true;
}

}  // namespace

extern "C" {

void* qps_parse(const char* path) {
    auto* p = new Problem();
    // No exception may escape across the extern "C"/ctypes boundary: a
    // malformed number (std::stod), a short line, or an inconsistent BOUNDS
    // section would otherwise abort the embedding Python process instead of
    // surfacing through qps_error and the documented Python-parser fallback.
    try {
        if (!parse(path, *p)) {
            if (p->error.empty()) p->error = "parse error";
        }
    } catch (const std::exception& e) {
        p->error = std::string("parse exception: ") + e.what();
    } catch (...) {
        p->error = "parse exception";
    }
    return p;
}

const char* qps_error(void* h) {
    auto* p = static_cast<Problem*>(h);
    return p->error.empty() ? nullptr : p->error.c_str();
}

const char* qps_get_name(void* h) {
    return static_cast<Problem*>(h)->name.c_str();
}

void qps_sizes(void* h, int64_t* n, int64_t* m, int64_t* annz, int64_t* qnnz) {
    auto* p = static_cast<Problem*>(h);
    *n = p->n;
    *m = p->m;
    *annz = (int64_t)p->A.size();
    *qnnz = (int64_t)p->Q.size();
}

double qps_constant(void* h) { return static_cast<Problem*>(h)->c; }

void qps_fill(void* h, int64_t* Ar, int64_t* Ac, double* Av, int64_t* Qr,
              int64_t* Qc, double* Qv, double* q, double* bmin, double* bmax) {
    auto* p = static_cast<Problem*>(h);
    for (size_t k = 0; k < p->A.size(); ++k) {
        Ar[k] = p->A[k].r;
        Ac[k] = p->A[k].c;
        Av[k] = p->A[k].v;
    }
    for (size_t k = 0; k < p->Q.size(); ++k) {
        Qr[k] = p->Q[k].r;
        Qc[k] = p->Q[k].c;
        Qv[k] = p->Q[k].v;
    }
    std::memcpy(q, p->q.data(), p->q.size() * sizeof(double));
    std::memcpy(bmin, p->bmin.data(), p->bmin.size() * sizeof(double));
    std::memcpy(bmax, p->bmax.data(), p->bmax.size() * sizeof(double));
}

void qps_free(void* h) { delete static_cast<Problem*>(h); }

}  // extern "C"
