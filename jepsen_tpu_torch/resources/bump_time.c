/* Clock-fault helper, compiled on DB nodes by
 * jepsen_tpu_torch.nemesis.ClockNemesis
 * (role of the upstream jepsen resources/bump-time.c; independent
 * implementation).
 *
 *   bump-time bump <delta-ms>                     jump the clock once
 *   bump-time strobe <delta-ms> <period-ms> <duration-ms>
 *                                                 flap the clock +-delta
 *   bump-time reset                               best-effort NTP-less reset
 *                                                 (clears nothing; exits 0 so
 *                                                 drivers fall through to
 *                                                 ntpdate/chrony)
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/time.h>
#include <unistd.h>

static int bump(long delta_ms) {
    struct timeval tv;
    if (gettimeofday(&tv, NULL) != 0) { perror("gettimeofday"); return 1; }
    long long us = (long long)tv.tv_sec * 1000000LL + tv.tv_usec
                 + (long long)delta_ms * 1000LL;
    tv.tv_sec  = (time_t)(us / 1000000LL);
    tv.tv_usec = (suseconds_t)(us % 1000000LL);
    if (settimeofday(&tv, NULL) != 0) { perror("settimeofday"); return 1; }
    return 0;
}

int main(int argc, char **argv) {
    if (argc < 2) { fprintf(stderr, "usage: bump-time bump|strobe|reset ...\n"); return 2; }
    if (strcmp(argv[1], "bump") == 0 && argc >= 3)
        return bump(atol(argv[2]));
    if (strcmp(argv[1], "strobe") == 0 && argc >= 5) {
        long delta = atol(argv[2]), period = atol(argv[3]), dur = atol(argv[4]);
        long elapsed = 0; int sign = 1;
        while (elapsed < dur) {
            if (bump(sign * delta)) return 1;
            sign = -sign;
            usleep((useconds_t)(period * 1000));
            elapsed += period;
        }
        return 0;
    }
    if (strcmp(argv[1], "reset") == 0)
        return 0;
    fprintf(stderr, "bad args\n");
    return 2;
}
