// Generated by imageenhancement_mp_tpu_torch/kernels/median_networks.py from
// the schedules it builds; do not edit.  Re-render with
//   python -m imageenhancement_mp_tpu_torch.kernels.median_networks
// tests/test_torch_median_networks.py proves every output of every schedule
// on every 0/1 window (the 0-1 principle) and checks that this file is the
// module's rendering.
//
// median_tile<K, V>: the K x K medians of a 2 x 2 tile of outputs from a
// (K + 1) x (K + 1) footprint t, in each lane of V.  Window (r, c) is
// t[r .. r + K - 1][c .. c + K - 1].  The two output rows share K - 1 rows
// of every window and neighbouring columns K - 1 columns; the schedule sorts
// and merges those once (A. Adams, "Fast Median Filters Using Separable
// Sorting Networks", ACM TOG 40(4), 2021).
// median_single<K, V>: one K x K median (fused.cu's reflected entries).
//
// median_tile5: 2x2 outputs, 268 operations, 67 per output (two lanes: half an instruction each)
// median_tile3: 2x2 outputs, 66 operations, 16.5 per output (two lanes: half an instruction each)
// median_single5: 1x1 outputs, 182 operations, 182 per output
// median_single3: 1x1 outputs, 31 operations, 31 per output
#pragma once

#include <cstdint>

namespace {

// Two 16-bit lanes per register, so one VIMNMX orders two pixels: unsigned
// lanes for u8 (widened) and u16, signed lanes for i16.  The three-way forms
// are one VIMNMX3 each on sm_90.
struct LanesU16 {
  using T = uint32_t;
  static __device__ __forceinline__ T mn(T a, T b) { return __vminu2(a, b); }
  static __device__ __forceinline__ T mx(T a, T b) { return __vmaxu2(a, b); }
  static __device__ __forceinline__ T mn3(T a, T b, T c) { return __vimin3_u16x2(a, b, c); }
  static __device__ __forceinline__ T mx3(T a, T b, T c) { return __vimax3_u16x2(a, b, c); }
};

struct LanesS16 {
  using T = uint32_t;
  static __device__ __forceinline__ T mn(T a, T b) { return __vmins2(a, b); }
  static __device__ __forceinline__ T mx(T a, T b) { return __vmaxs2(a, b); }
  static __device__ __forceinline__ T mn3(T a, T b, T c) { return __vimin3_s16x2(a, b, c); }
  static __device__ __forceinline__ T mx3(T a, T b, T c) { return __vimax3_s16x2(a, b, c); }
};

// One value per register (any of u8, u16, i16 held as int).
struct ScalarInt {
  using T = int;
  static __device__ __forceinline__ T mn(T a, T b) { return min(a, b); }
  static __device__ __forceinline__ T mx(T a, T b) { return max(a, b); }
  static __device__ __forceinline__ T mn3(T a, T b, T c) { return __vimin3_s32(a, b, c); }
  static __device__ __forceinline__ T mx3(T a, T b, T c) { return __vimax3_s32(a, b, c); }
};

// A thread's 2 x 4 outputs: lane 0 holds columns 0 and 1, lane 1 columns 2
// and 3, so footprint column j pairs the staged elements e[j] (lane 0) and
// e[j + 2] (lane 1).  lane_pairs forms the six pairs of e[0..7] from two
// 32-bit (u8) or 64-bit (u16, i16) shared-memory loads; p is 4- (u8) or
// 8-byte (16-bit) aligned.  u8 is widened into the 16-bit lanes.
__device__ __forceinline__ void lane_pairs(const uint8_t* p, uint32_t (&q)[6]) {
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
  const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + 4);
  const uint32_t mid = __byte_perm(w0, w1, 0x5432);  // e2 e3 e4 e5
  q[0] = __byte_perm(w0, 0, 0x4240);
  q[1] = __byte_perm(w0, 0, 0x4341);
  q[2] = __byte_perm(mid, 0, 0x4240);
  q[3] = __byte_perm(mid, 0, 0x4341);
  q[4] = __byte_perm(w1, 0, 0x4240);
  q[5] = __byte_perm(w1, 0, 0x4341);
}

template <typename T16>
__device__ __forceinline__ void lane_pairs(const T16* p, uint32_t (&q)[6]) {
  static_assert(sizeof(T16) == 2, "16-bit elements");
  const uint2 a = *reinterpret_cast<const uint2*>(p);      // e0 e1 | e2 e3
  const uint2 b = *reinterpret_cast<const uint2*>(p + 4);  // e4 e5 | e6 e7
  q[0] = __byte_perm(a.x, a.y, 0x5410);
  q[1] = __byte_perm(a.x, a.y, 0x7632);
  q[2] = __byte_perm(a.y, b.x, 0x5410);
  q[3] = __byte_perm(a.y, b.x, 0x7632);
  q[4] = __byte_perm(b.x, b.y, 0x5410);
  q[5] = __byte_perm(b.x, b.y, 0x7632);
}

// Output column e (0..3) of an output row of the tile: lane e >> 1 of o[e & 1].
__device__ __forceinline__ uint32_t lane_output(const uint32_t (&o)[2], int e) {
  return (o[e & 1] >> (16 * (e >> 1))) & 0xffffu;
}

template <class V>
__device__ __forceinline__ void median_tile5(const typename V::T (&t)[6][6], typename V::T (&o)[2][2]) {
  using T = typename V::T;
  const T v0 = V::mn(t[1][1], t[2][1]);
  const T v1 = V::mn(t[3][1], t[4][1]);
  const T v2 = V::mn(v0, v1);
  const T v3 = V::mn(t[1][2], t[2][2]);
  const T v4 = V::mn(t[3][2], t[4][2]);
  const T v5 = V::mn(v3, v4);
  const T v6 = V::mn(v2, v5);
  const T v7 = V::mn(t[1][3], t[2][3]);
  const T v8 = V::mn(t[3][3], t[4][3]);
  const T v9 = V::mn(v7, v8);
  const T v10 = V::mn(t[1][4], t[2][4]);
  const T v11 = V::mn(t[3][4], t[4][4]);
  const T v12 = V::mn(v10, v11);
  const T v13 = V::mn(v9, v12);
  const T v14 = V::mx(v6, v13);
  const T v15 = V::mx(v2, v5);
  const T v16 = V::mx(v0, v1);
  const T v17 = V::mx(t[1][1], t[2][1]);
  const T v18 = V::mx(t[3][1], t[4][1]);
  const T v19 = V::mn(v17, v18);
  const T v20 = V::mx(v16, v19);
  const T v21 = V::mx(v3, v4);
  const T v22 = V::mx(t[1][2], t[2][2]);
  const T v23 = V::mx(t[3][2], t[4][2]);
  const T v24 = V::mn(v22, v23);
  const T v25 = V::mx(v21, v24);
  const T v26 = V::mn(v20, v25);
  const T v27 = V::mx(v15, v26);
  const T v28 = V::mn(v16, v19);
  const T v29 = V::mn(v21, v24);
  const T v30 = V::mx(v28, v29);
  const T v31 = V::mx(v17, v18);
  const T v32 = V::mx(v22, v23);
  const T v33 = V::mn(v31, v32);
  const T v34 = V::mn(v30, v33);
  const T v35 = V::mx(v27, v34);
  const T v36 = V::mx(v9, v12);
  const T v37 = V::mx(v7, v8);
  const T v38 = V::mx(t[1][3], t[2][3]);
  const T v39 = V::mx(t[3][3], t[4][3]);
  const T v40 = V::mn(v38, v39);
  const T v41 = V::mx(v37, v40);
  const T v42 = V::mx(v10, v11);
  const T v43 = V::mx(t[1][4], t[2][4]);
  const T v44 = V::mx(t[3][4], t[4][4]);
  const T v45 = V::mn(v43, v44);
  const T v46 = V::mx(v42, v45);
  const T v47 = V::mn(v41, v46);
  const T v48 = V::mx(v36, v47);
  const T v49 = V::mn(v37, v40);
  const T v50 = V::mn(v42, v45);
  const T v51 = V::mx(v49, v50);
  const T v52 = V::mx(v38, v39);
  const T v53 = V::mx(v43, v44);
  const T v54 = V::mn(v52, v53);
  const T v55 = V::mn(v51, v54);
  const T v56 = V::mx(v48, v55);
  const T v57 = V::mn(v35, v56);
  const T v58 = V::mn(v14, v57);
  const T v59 = V::mn(v15, v26);
  const T v60 = V::mn(v28, v29);
  const T v61 = V::mx(v59, v60);
  const T v62 = V::mn(v36, v47);
  const T v63 = V::mn(v49, v50);
  const T v64 = V::mx(v62, v63);
  const T v65 = V::mn(v61, v64);
  const T v66 = V::mx(v58, v65);
  const T v67 = V::mn(v59, v60);
  const T v68 = V::mn(v62, v63);
  const T v69 = V::mx(v67, v68);
  const T v70 = V::mx(v20, v25);
  const T v71 = V::mx(v30, v33);
  const T v72 = V::mn(v70, v71);
  const T v73 = V::mx(v41, v46);
  const T v74 = V::mx(v51, v54);
  const T v75 = V::mn(v73, v74);
  const T v76 = V::mn(v72, v75);
  const T v77 = V::mn(v69, v76);
  const T v78 = V::mn(v27, v34);
  const T v79 = V::mn(v48, v55);
  const T v80 = V::mn(v78, v79);
  const T v81 = V::mn(v77, v80);
  const T v82 = V::mx(v66, v81);
  const T v83 = V::mx(v14, v57);
  const T v84 = V::mx(v61, v64);
  const T v85 = V::mx(v70, v71);
  const T v86 = V::mx(v73, v74);
  const T v87 = V::mn(v85, v86);
  const T v88 = V::mn(v84, v87);
  const T v89 = V::mx(v83, v88);
  const T v90 = V::mx(v69, v76);
  const T v91 = V::mx(v78, v79);
  const T v92 = V::mx(v31, v32);
  const T v93 = V::mx(v52, v53);
  const T v94 = V::mn(v92, v93);
  const T v95 = V::mn(v91, v94);
  const T v96 = V::mn(v90, v95);
  const T v97 = V::mx(v89, v96);
  const T v98 = V::mn(t[1][0], t[2][0]);
  const T v99 = V::mn(t[3][0], t[4][0]);
  const T v100 = V::mn(v98, v99);
  const T v101 = V::mn(v6, v13);
  const T v102 = V::mx(v100, v101);
  const T v103 = V::mn(v97, v102);
  const T v104 = V::mn(v83, v88);
  const T v105 = V::mx(v77, v80);
  const T v106 = V::mx(v104, v105);
  const T v107 = V::mx(v35, v56);
  const T v108 = V::mx(v84, v87);
  const T v109 = V::mn(v107, v108);
  const T v110 = V::mx(v90, v95);
  const T v111 = V::mx(v109, v110);
  const T v112 = V::mx(v98, v99);
  const T v113 = V::mx(t[1][0], t[2][0]);
  const T v114 = V::mx(t[3][0], t[4][0]);
  const T v115 = V::mn(v113, v114);
  const T v116 = V::mn(v58, v65);
  const T v117 = V::mn(v67, v68);
  const T v118 = V::mx(v116, v117);
  const T v119 = V::mx3(v112, v115, v118);
  const T v120 = V::mn(v111, v119);
  const T v121 = V::mn(v106, v120);
  const T v122 = V::mx3(v82, v103, v121);
  const T v123 = V::mn(v104, v105);
  const T v124 = V::mn(v109, v110);
  const T v125 = V::mn(v112, v115);
  const T v126 = V::mn(v116, v117);
  const T v127 = V::mx(v125, v126);
  const T v128 = V::mn(v124, v127);
  const T v129 = V::mx(v123, v128);
  const T v130 = V::mn(v89, v96);
  const T v131 = V::mx(v107, v108);
  const T v132 = V::mx(v72, v75);
  const T v133 = V::mx(v91, v94);
  const T v134 = V::mn(v132, v133);
  const T v135 = V::mn(v131, v134);
  const T v136 = V::mn(v66, v81);
  const T v137 = V::mx3(v113, v114, v136);
  const T v138 = V::mn(v135, v137);
  const T v139 = V::mn(v130, v138);
  const T v140 = V::mn(v129, v139);
  const T v141 = V::mn(v122, v140);
  const T v142 = V::mn(t[0][1], t[0][2]);
  const T v143 = V::mn(t[0][3], t[0][4]);
  const T v144 = V::mn(v142, v143);
  const T v145 = V::mx(v131, v134);
  const T v146 = V::mx(v97, v102);
  const T v147 = V::mn(v145, v146);
  const T v148 = V::mx(v106, v120);
  const T v149 = V::mx(v147, v148);
  const T v150 = V::mx(v85, v86);
  const T v151 = V::mx(v132, v133);
  const T v152 = V::mn(v150, v151);
  const T v153 = V::mx(v124, v127);
  const T v154 = V::mx(v130, v138);
  const T v155 = V::mn3(v152, v153, v154);
  const T v156 = V::mx(v149, v155);
  const T v157 = V::mn3(t[0][0], v144, v156);
  const T v158 = V::mx(v142, v143);
  const T v159 = V::mx(t[0][1], t[0][2]);
  const T v160 = V::mx(t[0][3], t[0][4]);
  const T v161 = V::mn(v159, v160);
  const T v162 = V::mn(v158, v161);
  const T v163 = V::mx(v158, v161);
  const T v164 = V::mx(t[0][0], v144);
  const T v165 = V::mn(v163, v164);
  const T v166 = V::mn(v149, v155);
  const T v167 = V::mn3(v162, v165, v166);
  const T v168 = V::mx3(v141, v157, v167);
  const T v169 = V::mx(v162, v165);
  const T v170 = V::mn(v147, v148);
  const T v171 = V::mx(v129, v139);
  const T v172 = V::mx(v170, v171);
  const T v173 = V::mn(v169, v172);
  const T v174 = V::mx(v159, v160);
  const T v175 = V::mx(v163, v164);
  const T v176 = V::mn(v170, v171);
  const T v177 = V::mn3(v174, v175, v176);
  const T v178 = V::mx(v174, v175);
  const T v179 = V::mx(v122, v140);
  const T v180 = V::mn(v178, v179);
  const T v181 = V::mx3(v173, v177, v180);
  const T v182 = V::mx(v168, v181);
  const T v183 = V::mn(t[1][5], t[2][5]);
  const T v184 = V::mn(t[3][5], t[4][5]);
  const T v185 = V::mn(v183, v184);
  const T v186 = V::mx(v101, v185);
  const T v187 = V::mn(v97, v186);
  const T v188 = V::mx(v183, v184);
  const T v189 = V::mx(t[1][5], t[2][5]);
  const T v190 = V::mx(t[3][5], t[4][5]);
  const T v191 = V::mn(v189, v190);
  const T v192 = V::mx3(v118, v188, v191);
  const T v193 = V::mn(v111, v192);
  const T v194 = V::mn(v106, v193);
  const T v195 = V::mx3(v82, v187, v194);
  const T v196 = V::mn(v188, v191);
  const T v197 = V::mx(v126, v196);
  const T v198 = V::mn(v124, v197);
  const T v199 = V::mx(v123, v198);
  const T v200 = V::mx3(v136, v189, v190);
  const T v201 = V::mn(v135, v200);
  const T v202 = V::mn(v130, v201);
  const T v203 = V::mn(v199, v202);
  const T v204 = V::mn(v195, v203);
  const T v205 = V::mx(v97, v186);
  const T v206 = V::mn(v145, v205);
  const T v207 = V::mx(v106, v193);
  const T v208 = V::mx(v206, v207);
  const T v209 = V::mx(v124, v197);
  const T v210 = V::mx(v130, v201);
  const T v211 = V::mn3(v152, v209, v210);
  const T v212 = V::mx(v208, v211);
  const T v213 = V::mn3(t[0][5], v144, v212);
  const T v214 = V::mx(t[0][5], v144);
  const T v215 = V::mn(v163, v214);
  const T v216 = V::mn(v208, v211);
  const T v217 = V::mn3(v162, v215, v216);
  const T v218 = V::mx3(v204, v213, v217);
  const T v219 = V::mx(v162, v215);
  const T v220 = V::mn(v206, v207);
  const T v221 = V::mx(v199, v202);
  const T v222 = V::mx(v220, v221);
  const T v223 = V::mn(v219, v222);
  const T v224 = V::mx(v163, v214);
  const T v225 = V::mn(v220, v221);
  const T v226 = V::mn3(v174, v224, v225);
  const T v227 = V::mx(v174, v224);
  const T v228 = V::mx(v195, v203);
  const T v229 = V::mn(v227, v228);
  const T v230 = V::mx3(v223, v226, v229);
  const T v231 = V::mx(v218, v230);
  const T v232 = V::mx(t[5][1], t[5][2]);
  const T v233 = V::mx(t[5][3], t[5][4]);
  const T v234 = V::mx(v232, v233);
  const T v235 = V::mn(t[5][1], t[5][2]);
  const T v236 = V::mn(t[5][3], t[5][4]);
  const T v237 = V::mx(v235, v236);
  const T v238 = V::mn(v232, v233);
  const T v239 = V::mx(v237, v238);
  const T v240 = V::mn(v235, v236);
  const T v241 = V::mx(t[5][0], v240);
  const T v242 = V::mx(v239, v241);
  const T v243 = V::mx(v234, v242);
  const T v244 = V::mn(v179, v243);
  const T v245 = V::mn3(v176, v234, v242);
  const T v246 = V::mx3(v141, v244, v245);
  const T v247 = V::mn(v237, v238);
  const T v248 = V::mn(v239, v241);
  const T v249 = V::mx(v247, v248);
  const T v250 = V::mn(v172, v249);
  const T v251 = V::mn3(v166, v247, v248);
  const T v252 = V::mn3(t[5][0], v156, v240);
  const T v253 = V::mx3(v250, v251, v252);
  const T v254 = V::mx(v246, v253);
  const T v255 = V::mx(t[5][5], v240);
  const T v256 = V::mx(v239, v255);
  const T v257 = V::mx(v234, v256);
  const T v258 = V::mn(v228, v257);
  const T v259 = V::mn3(v225, v234, v256);
  const T v260 = V::mx3(v204, v258, v259);
  const T v261 = V::mn(v239, v255);
  const T v262 = V::mx(v247, v261);
  const T v263 = V::mn(v222, v262);
  const T v264 = V::mn3(v216, v247, v261);
  const T v265 = V::mn3(t[5][5], v212, v240);
  const T v266 = V::mx3(v263, v264, v265);
  const T v267 = V::mx(v260, v266);
  o[0][0] = v182;
  o[0][1] = v231;
  o[1][0] = v254;
  o[1][1] = v267;
}

template <class V>
__device__ __forceinline__ void median_tile3(const typename V::T (&t)[4][4], typename V::T (&o)[2][2]) {
  using T = typename V::T;
  const T v0 = V::mn(t[1][1], t[2][1]);
  const T v1 = V::mn(t[1][2], t[2][2]);
  const T v2 = V::mx(v0, v1);
  const T v3 = V::mx(t[1][1], t[2][1]);
  const T v4 = V::mx(t[1][2], t[2][2]);
  const T v5 = V::mn(v3, v4);
  const T v6 = V::mx(v2, v5);
  const T v7 = V::mn(t[1][0], t[2][0]);
  const T v8 = V::mn(v0, v1);
  const T v9 = V::mx(v7, v8);
  const T v10 = V::mn(v6, v9);
  const T v11 = V::mx(t[1][0], t[2][0]);
  const T v12 = V::mn(v2, v5);
  const T v13 = V::mn(v11, v12);
  const T v14 = V::mn(v10, v13);
  const T v15 = V::mn(t[0][1], t[0][2]);
  const T v16 = V::mx(v6, v9);
  const T v17 = V::mx(v3, v4);
  const T v18 = V::mx(v11, v12);
  const T v19 = V::mn(v17, v18);
  const T v20 = V::mx(v16, v19);
  const T v21 = V::mn3(t[0][0], v15, v20);
  const T v22 = V::mx(t[0][1], t[0][2]);
  const T v23 = V::mx(t[0][0], v15);
  const T v24 = V::mn(v16, v19);
  const T v25 = V::mn3(v22, v23, v24);
  const T v26 = V::mx3(v14, v21, v25);
  const T v27 = V::mx(v22, v23);
  const T v28 = V::mx(v10, v13);
  const T v29 = V::mn(v27, v28);
  const T v30 = V::mx(v26, v29);
  const T v31 = V::mn(t[1][3], t[2][3]);
  const T v32 = V::mx(v8, v31);
  const T v33 = V::mn(v6, v32);
  const T v34 = V::mx(t[1][3], t[2][3]);
  const T v35 = V::mn(v12, v34);
  const T v36 = V::mn(v33, v35);
  const T v37 = V::mx(v6, v32);
  const T v38 = V::mx(v12, v34);
  const T v39 = V::mn(v17, v38);
  const T v40 = V::mx(v37, v39);
  const T v41 = V::mn3(t[0][3], v15, v40);
  const T v42 = V::mx(t[0][3], v15);
  const T v43 = V::mn(v37, v39);
  const T v44 = V::mn3(v22, v42, v43);
  const T v45 = V::mx3(v36, v41, v44);
  const T v46 = V::mx(v22, v42);
  const T v47 = V::mx(v33, v35);
  const T v48 = V::mn(v46, v47);
  const T v49 = V::mx(v45, v48);
  const T v50 = V::mx(t[3][1], t[3][2]);
  const T v51 = V::mn(t[3][1], t[3][2]);
  const T v52 = V::mx(t[3][0], v51);
  const T v53 = V::mx(v50, v52);
  const T v54 = V::mn(v28, v53);
  const T v55 = V::mn3(v24, v50, v52);
  const T v56 = V::mx3(v14, v54, v55);
  const T v57 = V::mn3(t[3][0], v20, v51);
  const T v58 = V::mx(v56, v57);
  const T v59 = V::mx(t[3][3], v51);
  const T v60 = V::mx(v50, v59);
  const T v61 = V::mn(v47, v60);
  const T v62 = V::mn3(v43, v50, v59);
  const T v63 = V::mx3(v36, v61, v62);
  const T v64 = V::mn3(t[3][3], v40, v51);
  const T v65 = V::mx(v63, v64);
  o[0][0] = v30;
  o[0][1] = v49;
  o[1][0] = v58;
  o[1][1] = v65;
}

template <class V>
__device__ __forceinline__ typename V::T median_single5(const typename V::T (&t)[5][5]) {
  using T = typename V::T;
  const T v0 = V::mn(t[1][1], t[2][1]);
  const T v1 = V::mn(t[3][1], t[4][1]);
  const T v2 = V::mn(v0, v1);
  const T v3 = V::mn(t[1][2], t[2][2]);
  const T v4 = V::mn(t[3][2], t[4][2]);
  const T v5 = V::mn(v3, v4);
  const T v6 = V::mn(v2, v5);
  const T v7 = V::mn(t[1][3], t[2][3]);
  const T v8 = V::mn(t[3][3], t[4][3]);
  const T v9 = V::mn(v7, v8);
  const T v10 = V::mn(t[1][4], t[2][4]);
  const T v11 = V::mn(t[3][4], t[4][4]);
  const T v12 = V::mn(v10, v11);
  const T v13 = V::mn(v9, v12);
  const T v14 = V::mx(v6, v13);
  const T v15 = V::mx(v2, v5);
  const T v16 = V::mx(v0, v1);
  const T v17 = V::mx(t[1][1], t[2][1]);
  const T v18 = V::mx(t[3][1], t[4][1]);
  const T v19 = V::mn(v17, v18);
  const T v20 = V::mx(v16, v19);
  const T v21 = V::mx(v3, v4);
  const T v22 = V::mx(t[1][2], t[2][2]);
  const T v23 = V::mx(t[3][2], t[4][2]);
  const T v24 = V::mn(v22, v23);
  const T v25 = V::mx(v21, v24);
  const T v26 = V::mn(v20, v25);
  const T v27 = V::mx(v15, v26);
  const T v28 = V::mn(v16, v19);
  const T v29 = V::mn(v21, v24);
  const T v30 = V::mx(v28, v29);
  const T v31 = V::mx(v17, v18);
  const T v32 = V::mx(v22, v23);
  const T v33 = V::mn(v31, v32);
  const T v34 = V::mn(v30, v33);
  const T v35 = V::mx(v27, v34);
  const T v36 = V::mx(v9, v12);
  const T v37 = V::mx(v7, v8);
  const T v38 = V::mx(t[1][3], t[2][3]);
  const T v39 = V::mx(t[3][3], t[4][3]);
  const T v40 = V::mn(v38, v39);
  const T v41 = V::mx(v37, v40);
  const T v42 = V::mx(v10, v11);
  const T v43 = V::mx(t[1][4], t[2][4]);
  const T v44 = V::mx(t[3][4], t[4][4]);
  const T v45 = V::mn(v43, v44);
  const T v46 = V::mx(v42, v45);
  const T v47 = V::mn(v41, v46);
  const T v48 = V::mx(v36, v47);
  const T v49 = V::mn(v37, v40);
  const T v50 = V::mn(v42, v45);
  const T v51 = V::mx(v49, v50);
  const T v52 = V::mx(v38, v39);
  const T v53 = V::mx(v43, v44);
  const T v54 = V::mn(v52, v53);
  const T v55 = V::mn(v51, v54);
  const T v56 = V::mx(v48, v55);
  const T v57 = V::mn(v35, v56);
  const T v58 = V::mn(v14, v57);
  const T v59 = V::mn(v15, v26);
  const T v60 = V::mn(v28, v29);
  const T v61 = V::mx(v59, v60);
  const T v62 = V::mn(v36, v47);
  const T v63 = V::mn(v49, v50);
  const T v64 = V::mx(v62, v63);
  const T v65 = V::mn(v61, v64);
  const T v66 = V::mx(v58, v65);
  const T v67 = V::mn(v59, v60);
  const T v68 = V::mn(v62, v63);
  const T v69 = V::mx(v67, v68);
  const T v70 = V::mx(v20, v25);
  const T v71 = V::mx(v30, v33);
  const T v72 = V::mn(v70, v71);
  const T v73 = V::mx(v41, v46);
  const T v74 = V::mx(v51, v54);
  const T v75 = V::mn(v73, v74);
  const T v76 = V::mn(v72, v75);
  const T v77 = V::mn(v69, v76);
  const T v78 = V::mn(v27, v34);
  const T v79 = V::mn(v48, v55);
  const T v80 = V::mn(v78, v79);
  const T v81 = V::mn(v77, v80);
  const T v82 = V::mx(v14, v57);
  const T v83 = V::mx(v61, v64);
  const T v84 = V::mx(v70, v71);
  const T v85 = V::mx(v73, v74);
  const T v86 = V::mn(v84, v85);
  const T v87 = V::mn(v83, v86);
  const T v88 = V::mx(v82, v87);
  const T v89 = V::mx(v69, v76);
  const T v90 = V::mx(v78, v79);
  const T v91 = V::mx(v31, v32);
  const T v92 = V::mx(v52, v53);
  const T v93 = V::mn(v91, v92);
  const T v94 = V::mn(v90, v93);
  const T v95 = V::mn(v89, v94);
  const T v96 = V::mx(v88, v95);
  const T v97 = V::mn(t[1][0], t[2][0]);
  const T v98 = V::mn(t[3][0], t[4][0]);
  const T v99 = V::mn(v97, v98);
  const T v100 = V::mn(v6, v13);
  const T v101 = V::mx(v99, v100);
  const T v102 = V::mn(v96, v101);
  const T v103 = V::mx3(v66, v81, v102);
  const T v104 = V::mn(v82, v87);
  const T v105 = V::mx(v77, v80);
  const T v106 = V::mx(v104, v105);
  const T v107 = V::mx(v35, v56);
  const T v108 = V::mx(v83, v86);
  const T v109 = V::mn(v107, v108);
  const T v110 = V::mx(v89, v94);
  const T v111 = V::mx(v109, v110);
  const T v112 = V::mx(v97, v98);
  const T v113 = V::mx(t[1][0], t[2][0]);
  const T v114 = V::mx(t[3][0], t[4][0]);
  const T v115 = V::mn(v113, v114);
  const T v116 = V::mn(v58, v65);
  const T v117 = V::mn(v67, v68);
  const T v118 = V::mx(v116, v117);
  const T v119 = V::mx3(v112, v115, v118);
  const T v120 = V::mn(v111, v119);
  const T v121 = V::mn(v106, v120);
  const T v122 = V::mx(v103, v121);
  const T v123 = V::mn(v104, v105);
  const T v124 = V::mn(v109, v110);
  const T v125 = V::mn(v112, v115);
  const T v126 = V::mn(v116, v117);
  const T v127 = V::mx(v125, v126);
  const T v128 = V::mn(v124, v127);
  const T v129 = V::mx(v123, v128);
  const T v130 = V::mn(v88, v95);
  const T v131 = V::mx(v107, v108);
  const T v132 = V::mx(v72, v75);
  const T v133 = V::mx(v90, v93);
  const T v134 = V::mn(v132, v133);
  const T v135 = V::mn(v66, v81);
  const T v136 = V::mx3(v113, v114, v135);
  const T v137 = V::mn3(v131, v134, v136);
  const T v138 = V::mn(v130, v137);
  const T v139 = V::mn(v129, v138);
  const T v140 = V::mn(v122, v139);
  const T v141 = V::mn(t[0][1], t[0][2]);
  const T v142 = V::mn(t[0][3], t[0][4]);
  const T v143 = V::mn(v141, v142);
  const T v144 = V::mx(v131, v134);
  const T v145 = V::mx(v96, v101);
  const T v146 = V::mn(v144, v145);
  const T v147 = V::mx(v106, v120);
  const T v148 = V::mx(v146, v147);
  const T v149 = V::mx(v84, v85);
  const T v150 = V::mx(v132, v133);
  const T v151 = V::mx(v124, v127);
  const T v152 = V::mn3(v149, v150, v151);
  const T v153 = V::mx(v130, v137);
  const T v154 = V::mn(v152, v153);
  const T v155 = V::mx(v148, v154);
  const T v156 = V::mn3(t[0][0], v143, v155);
  const T v157 = V::mx(v141, v142);
  const T v158 = V::mx(t[0][1], t[0][2]);
  const T v159 = V::mx(t[0][3], t[0][4]);
  const T v160 = V::mn(v158, v159);
  const T v161 = V::mn(v157, v160);
  const T v162 = V::mx(v157, v160);
  const T v163 = V::mx(t[0][0], v143);
  const T v164 = V::mn(v162, v163);
  const T v165 = V::mn(v148, v154);
  const T v166 = V::mn3(v161, v164, v165);
  const T v167 = V::mx3(v140, v156, v166);
  const T v168 = V::mx(v161, v164);
  const T v169 = V::mn(v146, v147);
  const T v170 = V::mx(v129, v138);
  const T v171 = V::mx(v169, v170);
  const T v172 = V::mn(v168, v171);
  const T v173 = V::mx(v158, v159);
  const T v174 = V::mx(v162, v163);
  const T v175 = V::mn(v169, v170);
  const T v176 = V::mn3(v173, v174, v175);
  const T v177 = V::mx(v173, v174);
  const T v178 = V::mx(v122, v139);
  const T v179 = V::mn(v177, v178);
  const T v180 = V::mx3(v172, v176, v179);
  const T v181 = V::mx(v167, v180);
  return v181;
}

template <class V>
__device__ __forceinline__ typename V::T median_single3(const typename V::T (&t)[3][3]) {
  using T = typename V::T;
  const T v0 = V::mn(t[1][1], t[2][1]);
  const T v1 = V::mn(t[1][2], t[2][2]);
  const T v2 = V::mx(v0, v1);
  const T v3 = V::mx(t[1][1], t[2][1]);
  const T v4 = V::mx(t[1][2], t[2][2]);
  const T v5 = V::mn(v3, v4);
  const T v6 = V::mx(v2, v5);
  const T v7 = V::mn(t[1][0], t[2][0]);
  const T v8 = V::mn(v0, v1);
  const T v9 = V::mx(v7, v8);
  const T v10 = V::mn(v6, v9);
  const T v11 = V::mx(t[1][0], t[2][0]);
  const T v12 = V::mn(v2, v5);
  const T v13 = V::mn(v11, v12);
  const T v14 = V::mn(v10, v13);
  const T v15 = V::mn(t[0][1], t[0][2]);
  const T v16 = V::mx(v6, v9);
  const T v17 = V::mx(v3, v4);
  const T v18 = V::mx(v11, v12);
  const T v19 = V::mn(v17, v18);
  const T v20 = V::mx(v16, v19);
  const T v21 = V::mn3(t[0][0], v15, v20);
  const T v22 = V::mx(t[0][1], t[0][2]);
  const T v23 = V::mx(t[0][0], v15);
  const T v24 = V::mn(v16, v19);
  const T v25 = V::mn3(v22, v23, v24);
  const T v26 = V::mx3(v14, v21, v25);
  const T v27 = V::mx(v22, v23);
  const T v28 = V::mx(v10, v13);
  const T v29 = V::mn(v27, v28);
  const T v30 = V::mx(v26, v29);
  return v30;
}

template <int K, class V>
__device__ __forceinline__ void median_tile(const typename V::T (&t)[K + 1][K + 1],
                                            typename V::T (&o)[2][2]) {
  if constexpr (K == 3) {
    median_tile3<V>(t, o);
  } else {
    median_tile5<V>(t, o);
  }
}

template <int K, class V>
__device__ __forceinline__ typename V::T median_single(const typename V::T (&t)[K][K]) {
  if constexpr (K == 3) {
    return median_single3<V>(t);
  } else {
    return median_single5<V>(t);
  }
}

}  // namespace
