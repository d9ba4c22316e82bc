/* Native EGA look-up-table parser (data-loader fast path).
 *
 * The reference's init_tbl (jurassic.c:311-416) parses one 4-column
 * ASCII file per (gas, channel) -- "minutes-long" at production table
 * sizes, which is why it is OpenMP-parallel over channels
 * (jurassic.c:329) and backed by a binary cache.  This is the native
 * equivalent: a C parser exposed through ctypes
 * (jurassic_torch/native/__init__.py), called from a thread pool (the
 * GIL is released during the call, so files parse in parallel like the
 * reference's channel loop).
 *
 * Index-advance rules replicated exactly (jurassic.c:355-394):
 *   - new pressure block when the pressure value changes;
 *   - new temperature block when the temperature value changes;
 *   - a (u, eps) entry is appended only when BOTH eps and u increase
 *     monotonically (or the block is empty); otherwise it OVERWRITES
 *     the previous entry (IDX_U unchanged, store still executed).
 *
 * Two-call protocol:
 *   jr_scan_dims(path, &nP, &maxT, &maxU)   -- cheap dimension scan
 *   jr_parse_tab(path, P, T, U, nt, nu, p, t, u, eps)  -- dense fill
 * Both return < 0 on I/O error, otherwise the number of pressure
 * blocks.  Output arrays are caller-allocated with the scanned caps:
 *   nt[P] (int32), nu[P*T] (int32), p[P] (f64), t[P*T] (f64),
 *   u[P*T*U] (f32), eps[P*T*U] (f32)
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* parse one whitespace-separated line of >= 4 doubles; returns 1 on
 * success (mirrors the TOK/sscanf skip-on-malformed behavior) */
static int parse4(const char *line, double *v) {
	char *end;
	const char *s = line;
	for (int i = 0; i < 4; ++i) {
		v[i] = strtod(s, &end);
		if (end == s) return 0;
		s = end;
	}
	return 1;
}

typedef struct {
	FILE *in;
	char buf[1 << 16];
} reader_t;

/* callback per parsed row; returns through state pointers */
#define FOR_EACH_ROW(path, BODY)                                        \
	FILE *in = fopen(path, "r");                                        \
	if (!in) return -1;                                                 \
	char *line = malloc(1 << 16);                                       \
	if (!line) { fclose(in); return -2; }                               \
	double v[4];                                                        \
	double press_old = -999., temp_old = -999.;                         \
	double u_old = -999., eps_old = -999.;                              \
	(void)press_old; (void)temp_old; (void)u_old; (void)eps_old;        \
	while (fgets(line, 1 << 16, in)) {                                  \
		if (!parse4(line, v)) continue;                                 \
		const double press = v[0], temp = v[1], uu = v[2], ee = v[3];   \
		(void)press; (void)temp; (void)uu; (void)ee;                    \
		BODY                                                            \
	}                                                                   \
	free(line);                                                         \
	fclose(in);

int jr_scan_dims(const char *path, int *nP, int *maxT, int *maxU) {
	int np = 0, nt = 0, nu = 0, mt = 0, mu = 0;
	FOR_EACH_ROW(path, {
		if (press != press_old) {
			press_old = press;
			++np;
			temp_old = -999.;
			if (nt > mt) mt = nt;
			nt = 0;
		}
		if (temp != temp_old) {
			temp_old = temp;
			++nt;
			if (nu > mu) mu = nu;
			nu = 0;
		}
		if ((ee > eps_old && uu > u_old) || nu == 0) {
			eps_old = ee; u_old = uu;
			++nu;
		} /* else: overwrite, count unchanged */
	})
	if (nt > mt) mt = nt;
	if (nu > mu) mu = nu;
	*nP = np;
	*maxT = mt;
	*maxU = mu;
	return np;
}

int jr_parse_tab(const char *path, int P, int T, int U,
                 int *nt, int *nu, double *p, double *t,
                 float *u, float *eps) {
	int ip = -1, it = -1, iu = -1;
	memset(nt, 0, sizeof(int) * (size_t)P);
	memset(nu, 0, sizeof(int) * (size_t)P * (size_t)T);
	FOR_EACH_ROW(path, {
		if (press != press_old) {
			press_old = press;
			if (++ip >= P) break;
			p[ip] = press;
			temp_old = -999.;
			it = -1;
		}
		if (temp != temp_old) {
			temp_old = temp;
			if (++it >= T) continue;
			t[ip * T + it] = temp;
			nt[ip] = it + 1;
			iu = -1;
		}
		if (it >= T) continue;
		if ((ee > eps_old && uu > u_old) || iu < 0) {
			eps_old = ee; u_old = uu;
			/* at cap: keep the previous entry and skip the store
			 * (IDX_U--; continue -- jurassic.c:373-378) */
			if (iu + 1 >= U) continue;
			++iu;
			nu[ip * T + it] = iu + 1;
		} /* else: overwrite the previous entry */
		const size_t k = ((size_t)ip * T + it) * U + iu;
		u[k] = (float)uu;
		eps[k] = (float)ee;
	})
	return ip + 1;
}
