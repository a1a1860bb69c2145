// Shared parameter tables for the exact CPU engine (filled once from Python
// via rp_set_params; values from priblast_tpu_torch.utils.thermo).
#pragma once

#include <cstdint>

namespace rp {

constexpr int TURN = 3;
constexpr int MAXLOOP = 30;
constexpr double NEG_INF = -1000000.0;  // the reference's finite "-INF"
constexpr double POS_INF = 1000000.0;

struct Params {
  int bp[5][5];   // pair-type map (0 = no pair)
  int rtype[7];   // reversed pair type
  double hairpin[31];
  double mismatch_h[7][5][5];
  double mismatch_i[7][5][5];
  double stack[7][7];
  double bulge[31];
  double internal[31];
  double int11[8][8][5][5];
  double int21[8][8][5][5][5];
  double int22[8][8][5][5][5][5];
  double dangle5[8][5];
  double dangle3[8][5];
  double ninio[31];
  double ml_closing, ml_intern, ml_base, term_au, kT, lxc;

  // raw integer tables (10*cal/mol) for the hybridization model of the
  // extension kernels (reference: src/energy_par.hpp, src/intloops.hpp)
  int stack37[7][7];
  int mismatchI37[7][5][5];
  int int11_37[8][8][5][5];
  int int21_37[8][8][5][5][5];
  int int22_37[8][8][5][5][5][5];
  int internal_loop37[31];
  int bulge37[31];
  int dangle5_37[8][5];
  int dangle3_37[8][5];
  int terminal_au37;
  bool ready = false;
};

extern Params g;

}  // namespace rp
