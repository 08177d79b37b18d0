/*
 * svt_av1_tpu_torch encoder plugin for FFmpeg
 *
 * The twin of libsvt_av1_tpu.c for the PyTorch/CUDA package: the same
 * process model and C, with the encoder CLI of svt_av1_tpu_torch. The
 * plugin spawns the encoder CLI once, streams Y4M frames down its
 * stdin, and reads IVF frames back from its stdout. Both pipe contracts
 * are tested interfaces of the encoder (svt_av1_tpu_torch/app/cli.py:
 * `-i -` consumes Y4M from stdin, `-b -` emits IVF on stdout with stats
 * on stderr). The encoder runs its pixel path on the first CUDA device
 * (the CLI's default `--device cuda`).
 *
 * Build:
 *   1. copy this file into libavcodec/ of an FFmpeg (>= 6.0) tree;
 *   2. libavcodec/Makefile:
 *        OBJS-$(CONFIG_LIBSVT_AV1_TPU_TORCH_ENCODER) += libsvt_av1_tpu_torch.o
 *      libavcodec/allcodecs.c:
 *        extern const FFCodec ff_libsvt_av1_tpu_torch_encoder;
 *      configure: add libsvt_av1_tpu_torch to EXTERNAL_LIBRARY_LIST and
 *        an `enabled libsvt_av1_tpu_torch && require python3 ...` probe
 *        (no C library to link: the dependency is the svt_av1_tpu_torch
 *        package on the target machine's python3, with torch for CUDA);
 *   3. ./configure --enable-libsvt_av1_tpu_torch && make
 * Use: ffmpeg -i in.mp4 -c:v libsvt_av1_tpu_torch -preset 5 -qp 40 out.ivf
 *
 * This file is part of FFmpeg.
 *
 * FFmpeg is free software; you can redistribute it and/or
 * modify it under the terms of the GNU Lesser General Public
 * License as published by the Free Software Foundation; either
 * version 2.1 of the License, or (at your option) any later version.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>
#include <sys/wait.h>
#include <fcntl.h>
#include <errno.h>

#include "libavutil/common.h"
#include "libavutil/frame.h"
#include "libavutil/imgutils.h"
#include "libavutil/opt.h"

#include "avcodec.h"
#include "codec_internal.h"
#include "encode.h"

typedef struct SvtTpuTorchContext {
    AVClass *class;

    pid_t child;            /* encoder process */
    int to_enc;             /* write end: Y4M frames */
    int from_enc;           /* read end: IVF stream */
    int eos_sent;
    int ivf_header_read;

    uint8_t *buf;           /* IVF read buffer */
    size_t buf_len, buf_cap;

    /* user options (mirror the CLI flags) */
    int preset;             /* M0..M8 */
    int qp;
    int hierarchical_level;
    int intra_period;
    int tile_columns;
    int rc_mode;
    int64_t target_bitrate;
    int la_depth;
    char *python;           /* interpreter running the encoder package */
} SvtTpuTorchContext;

static int write_all(int fd, const uint8_t *p, size_t n)
{
    while (n) {
        ssize_t w = write(fd, p, n);
        if (w < 0) {
            if (errno == EINTR)
                continue;
            return AVERROR(errno);
        }
        p += w;
        n -= (size_t)w;
    }
    return 0;
}

static int read_more(SvtTpuTorchContext *s)
{
    ssize_t r;
    if (s->buf_len + 65536 > s->buf_cap) {
        size_t cap = s->buf_cap ? s->buf_cap * 2 : 1 << 20;
        uint8_t *nb = av_realloc(s->buf, cap);
        if (!nb)
            return AVERROR(ENOMEM);
        s->buf = nb;
        s->buf_cap = cap;
    }
    r = read(s->from_enc, s->buf + s->buf_len, s->buf_cap - s->buf_len);
    if (r < 0) {
        if (errno == EINTR)
            return 0;
        /* O_NONBLOCK before EOS: no packet ready yet */
        return AVERROR(errno);
    }
    if (r == 0)
        return AVERROR_EOF;
    s->buf_len += (size_t)r;
    return 0;
}

static av_cold int svt_tpu_torch_init(AVCodecContext *avctx)
{
    SvtTpuTorchContext *s = avctx->priv_data;
    int in_pipe[2], out_pipe[2];
    char header[256];
    char arg_q[16], arg_preset[16], arg_n[16];

    if (avctx->pix_fmt != AV_PIX_FMT_YUV420P) {
        av_log(avctx, AV_LOG_ERROR, "only yuv420p supported\n");
        return AVERROR(EINVAL);
    }
    if (pipe(in_pipe) || pipe(out_pipe))
        return AVERROR(errno);

    s->child = fork();
    if (s->child < 0)
        return AVERROR(errno);
    if (s->child == 0) {
        dup2(in_pipe[0], 0);
        dup2(out_pipe[1], 1);
        close(in_pipe[1]);
        close(out_pipe[0]);
        snprintf(arg_q, sizeof(arg_q), "%d", s->qp);
        snprintf(arg_preset, sizeof(arg_preset), "%d", s->preset);
        snprintf(arg_n, sizeof(arg_n), "%d", s->hierarchical_level);
        execlp(s->python ? s->python : "python3",
               "python3", "-m", "svt_av1_tpu_torch.app",
               "-i", "-", "-b", "-", "--no-stats",
               "-q", arg_q, "--preset", arg_preset,
               "--hierarchical-levels", arg_n,
               (char *)NULL);
        _exit(127);
    }
    close(in_pipe[0]);
    close(out_pipe[1]);
    s->to_enc = in_pipe[1];
    s->from_enc = out_pipe[0];
    /* non-blocking reads until EOS: the encoder emits packets at
     * mini-GOP granularity, so mid-stream polls must return EAGAIN */
    fcntl(s->from_enc, F_SETFL, O_NONBLOCK);

    /* Y4M stream header (CLI reads geometry/rate from it) */
    snprintf(header, sizeof(header),
             "YUV4MPEG2 W%d H%d F%d:%d Ip A1:1 C420\n",
             avctx->width, avctx->height,
             avctx->time_base.den, avctx->time_base.num * avctx->ticks_per_frame);
    return write_all(s->to_enc, (uint8_t *)header, strlen(header));
}

static int svt_tpu_torch_write_frame(AVCodecContext *avctx, const AVFrame *frame)
{
    SvtTpuTorchContext *s = avctx->priv_data;
    int ret, p;

    if (!frame) {
        if (!s->eos_sent) {
            close(s->to_enc);       /* EOS: CLI flushes and exits */
            s->eos_sent = 1;
        }
        return 0;
    }
    if ((ret = write_all(s->to_enc, (const uint8_t *)"FRAME\n", 6)) < 0)
        return ret;
    for (p = 0; p < 3; p++) {
        int w = p ? (avctx->width + 1) / 2 : avctx->width;
        int h = p ? (avctx->height + 1) / 2 : avctx->height;
        int y;
        for (y = 0; y < h; y++) {
            ret = write_all(s->to_enc,
                            frame->data[p] + (size_t)y * frame->linesize[p],
                            w);
            if (ret < 0)
                return ret;
        }
    }
    return 0;
}

static int svt_tpu_torch_receive_packet(AVCodecContext *avctx, AVPacket *pkt)
{
    SvtTpuTorchContext *s = avctx->priv_data;
    int ret;

    /* pull the next input frame from the encode queue and pipe it in
     * (NULL frame = end of stream) */
    if (!s->eos_sent) {
        AVFrame *frame = av_frame_alloc();
        if (!frame)
            return AVERROR(ENOMEM);
        ret = ff_encode_get_frame(avctx, frame);
        if (ret >= 0)
            ret = svt_tpu_torch_write_frame(avctx, frame);
        else if (ret == AVERROR_EOF)
            ret = svt_tpu_torch_write_frame(avctx, NULL);
        av_frame_free(&frame);
        if (ret < 0 && ret != AVERROR(EAGAIN) && ret != AVERROR_EOF)
            return ret;
    }

    for (;;) {
        size_t need = s->ivf_header_read ? 12 : 32;
        uint32_t fsz;
        uint64_t pts;

        if (s->buf_len >= need) {
            if (!s->ivf_header_read) {
                if (memcmp(s->buf, "DKIF", 4)) {
                    av_log(avctx, AV_LOG_ERROR, "bad IVF magic\n");
                    return AVERROR_INVALIDDATA;
                }
                memmove(s->buf, s->buf + 32, s->buf_len - 32);
                s->buf_len -= 32;
                s->ivf_header_read = 1;
                continue;
            }
            fsz = AV_RL32(s->buf);
            pts = AV_RL64(s->buf + 4);
            if (s->buf_len >= 12 + (size_t)fsz) {
                ret = ff_get_encode_buffer(avctx, pkt, fsz, 0);
                if (ret < 0)
                    return ret;
                memcpy(pkt->data, s->buf + 12, fsz);
                pkt->pts = pkt->dts = (int64_t)pts;
                memmove(s->buf, s->buf + 12 + fsz,
                        s->buf_len - 12 - fsz);
                s->buf_len -= 12 + fsz;
                return 0;
            }
        }
        if (s->eos_sent) {
            /* stream closed: blocking reads drain the tail */
            int fl = fcntl(s->from_enc, F_GETFL);
            fcntl(s->from_enc, F_SETFL, fl & ~O_NONBLOCK);
        }
        ret = read_more(s);
        if (ret == AVERROR_EOF)
            return s->eos_sent ? AVERROR_EOF : AVERROR(EAGAIN);
        if (ret == AVERROR(EAGAIN))
            return AVERROR(EAGAIN);
        if (ret < 0)
            return ret;
    }
}

static av_cold int svt_tpu_torch_close(AVCodecContext *avctx)
{
    SvtTpuTorchContext *s = avctx->priv_data;
    if (!s->eos_sent && s->to_enc > 0)
        close(s->to_enc);
    if (s->from_enc > 0)
        close(s->from_enc);
    if (s->child > 0)
        waitpid(s->child, NULL, 0);
    av_freep(&s->buf);
    return 0;
}

#define OFFSET(x) offsetof(SvtTpuTorchContext, x)
#define VE AV_OPT_FLAG_VIDEO_PARAM | AV_OPT_FLAG_ENCODING_PARAM
static const AVOption options[] = {
    { "preset", "encoding preset M0..M8", OFFSET(preset),
      AV_OPT_TYPE_INT, { .i64 = 2 }, 0, 8, VE },
    { "qp", "quantizer 0..63", OFFSET(qp),
      AV_OPT_TYPE_INT, { .i64 = 40 }, 0, 63, VE },
    { "hielevel", "hierarchical levels", OFFSET(hierarchical_level),
      AV_OPT_TYPE_INT, { .i64 = 3 }, 0, 5, VE },
    { "python", "interpreter hosting the CUDA encoder", OFFSET(python),
      AV_OPT_TYPE_STRING, { .str = "python3" }, 0, 0, VE },
    { NULL },
};

static const AVClass class = {
    .class_name = "libsvt_av1_tpu_torch",
    .item_name  = av_default_item_name,
    .option     = options,
    .version    = LIBAVUTIL_VERSION_INT,
};

const FFCodec ff_libsvt_av1_tpu_torch_encoder = {
    .p.name         = "libsvt_av1_tpu_torch",
    CODEC_LONG_NAME("svt_av1_tpu_torch AV1 (CUDA process-model encoder)"),
    .p.type         = AVMEDIA_TYPE_VIDEO,
    .p.id           = AV_CODEC_ID_AV1,
    .p.capabilities = AV_CODEC_CAP_DELAY | AV_CODEC_CAP_OTHER_THREADS,
    .p.priv_class   = &class,
    .priv_data_size = sizeof(SvtTpuTorchContext),
    .init           = svt_tpu_torch_init,
    FF_CODEC_RECEIVE_PACKET_CB(svt_tpu_torch_receive_packet),
    .close          = svt_tpu_torch_close,
    .p.wrapper_name = "libsvt_av1_tpu_torch",
    .p.pix_fmts     = (const enum AVPixelFormat[]) {
        AV_PIX_FMT_YUV420P, AV_PIX_FMT_NONE },
};
