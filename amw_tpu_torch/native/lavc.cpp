// In-process lossy-codec boundary: MP3 / OPUS / AAC decode + encode via the
// system FFmpeg libraries (libavformat / libavcodec / libswresample).
//
// The reference routes these formats through a pydub -> ffmpeg-CLI
// subprocess (reference backend/app/pipeline.py:819-827 decode,
// :999-1052 encode).  Here the same codecs are driven in process: no
// fork/exec per job, no temp WAV intermediary, and the encode path is a
// single pass over an in-memory growable buffer.  WAV and FLAC never reach
// this file (utils/wav.py numpy codec + native/flac.cpp).
//
// C ABI (ctypes-bound in native/__init__.py):
//   amw_lavc_decode(data, size, &pcm, &frames, &channels, &sr, err, errlen)
//       -> 0 | negative.  pcm = malloc'd float32 interleaved [frames*ch].
//   amw_lavc_encode(pcm, frames, channels, sr, fmt, kbps,
//                   &out, &outsize, err, errlen)
//       -> 0 | negative.  fmt in {"mp3","opus","aac"}; out = malloc'd bytes.
//   amw_lavc_free(ptr)
//   amw_lavc_ok() -> 1 (link/load probe)

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/audio_fifo.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

void set_err(char *err, int errlen, const std::string &msg, int averr = 0) {
    if (!err || errlen <= 0) return;
    std::string full = msg;
    if (averr != 0) {
        char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
        av_strerror(averr, buf, sizeof(buf));
        full += ": ";
        full += buf;
    }
    std::snprintf(err, (size_t)errlen, "%s", full.c_str());
}

// ---- in-memory AVIO ------------------------------------------------------

struct ReadBuf {
    const uint8_t *data;
    int64_t size;
    int64_t pos;
};

int read_cb(void *opaque, uint8_t *buf, int buf_size) {
    ReadBuf *rb = (ReadBuf *)opaque;
    int64_t left = rb->size - rb->pos;
    if (left <= 0) return AVERROR_EOF;
    int n = (int)(left < buf_size ? left : buf_size);
    std::memcpy(buf, rb->data + rb->pos, (size_t)n);
    rb->pos += n;
    return n;
}

int64_t rseek_cb(void *opaque, int64_t offset, int whence) {
    ReadBuf *rb = (ReadBuf *)opaque;
    if (whence == AVSEEK_SIZE) return rb->size;
    whence &= ~AVSEEK_FORCE;
    int64_t p = offset;
    if (whence == SEEK_CUR) p = rb->pos + offset;
    else if (whence == SEEK_END) p = rb->size + offset;
    if (p < 0 || p > rb->size) return AVERROR(EINVAL);
    rb->pos = p;
    return p;
}

struct WriteBuf {
    std::vector<uint8_t> data;
    int64_t pos = 0;  // m4a muxer seeks back to patch the moov atom
};

int write_cb(void *opaque, uint8_t *buf, int buf_size) {
    WriteBuf *wb = (WriteBuf *)opaque;
    if (wb->pos + buf_size > (int64_t)wb->data.size())
        wb->data.resize((size_t)(wb->pos + buf_size));
    std::memcpy(wb->data.data() + wb->pos, buf, (size_t)buf_size);
    wb->pos += buf_size;
    return buf_size;
}

int64_t wseek_cb(void *opaque, int64_t offset, int whence) {
    WriteBuf *wb = (WriteBuf *)opaque;
    if (whence == AVSEEK_SIZE) return (int64_t)wb->data.size();
    whence &= ~AVSEEK_FORCE;
    int64_t p = offset;
    if (whence == SEEK_CUR) p = wb->pos + offset;
    else if (whence == SEEK_END) p = (int64_t)wb->data.size() + offset;
    if (p < 0) return AVERROR(EINVAL);
    wb->pos = p;
    return p;
}

}  // namespace

extern "C" {

int amw_lavc_ok() { return 1; }

void amw_lavc_free(void *p) { free(p); }

int amw_lavc_decode(const uint8_t *data, int64_t size, float **out_pcm,
                    int64_t *out_frames, int *out_channels, int *out_sr,
                    char *err, int errlen) {
    av_log_set_level(AV_LOG_ERROR);
    *out_pcm = nullptr;
    *out_frames = 0;
    *out_channels = 0;
    *out_sr = 0;

    ReadBuf rb = {data, size, 0};
    const int avio_buf_sz = 1 << 16;
    uint8_t *avio_buf = (uint8_t *)av_malloc(avio_buf_sz);
    AVIOContext *avio = avio_alloc_context(avio_buf, avio_buf_sz, 0, &rb,
                                           read_cb, nullptr, rseek_cb);
    AVFormatContext *fmt = avformat_alloc_context();
    fmt->pb = avio;
    fmt->flags |= AVFMT_FLAG_CUSTOM_IO;

    AVCodecContext *cc = nullptr;
    SwrContext *swr = nullptr;
    AVPacket *pkt = nullptr;
    AVFrame *frame = nullptr;
    std::vector<float> pcm;
    int ret = 0, stream_idx = -1, channels = 0, sr = 0;

    auto fail = [&](const std::string &m, int e) {
        set_err(err, errlen, m, e);
        if (swr) swr_free(&swr);
        if (cc) avcodec_free_context(&cc);
        if (pkt) av_packet_free(&pkt);
        if (frame) av_frame_free(&frame);
        avformat_close_input(&fmt);
        if (avio) {
            av_freep(&avio->buffer);
            avio_context_free(&avio);
        }
        return -1;
    };

    if ((ret = avformat_open_input(&fmt, nullptr, nullptr, nullptr)) < 0) {
        set_err(err, errlen, "open_input", ret);
        // open_input frees fmt on failure (custom AVIO survives)
        av_freep(&avio->buffer);
        avio_context_free(&avio);
        return -1;
    }
    if ((ret = avformat_find_stream_info(fmt, nullptr)) < 0)
        return fail("find_stream_info", ret);
    const AVCodec *dec = nullptr;
    stream_idx = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &dec, 0);
    if (stream_idx < 0 || !dec) return fail("no audio stream", stream_idx);
    AVStream *st = fmt->streams[stream_idx];

    cc = avcodec_alloc_context3(dec);
    if ((ret = avcodec_parameters_to_context(cc, st->codecpar)) < 0)
        return fail("parameters_to_context", ret);
    if ((ret = avcodec_open2(cc, dec, nullptr)) < 0)
        return fail("decoder open", ret);

    pkt = av_packet_alloc();
    frame = av_frame_alloc();

    auto push_frame = [&](AVFrame *f) -> int {
        if (!swr) {
            sr = f->sample_rate ? f->sample_rate : cc->sample_rate;
            AVChannelLayout in_layout;
            if (f->ch_layout.nb_channels > 0)
                av_channel_layout_copy(&in_layout, &f->ch_layout);
            else
                av_channel_layout_default(&in_layout, 2);
            channels = in_layout.nb_channels;
            int r = swr_alloc_set_opts2(&swr, &in_layout, AV_SAMPLE_FMT_FLT,
                                        sr, &in_layout,
                                        (AVSampleFormat)f->format, sr, 0,
                                        nullptr);
            av_channel_layout_uninit(&in_layout);
            if (r < 0 || (r = swr_init(swr)) < 0) return r;
        }
        int out_n = (int)av_rescale_rnd(
            swr_get_delay(swr, sr) + f->nb_samples, sr, sr, AV_ROUND_UP);
        size_t base = pcm.size();
        pcm.resize(base + (size_t)out_n * channels);
        uint8_t *outp = (uint8_t *)(pcm.data() + base);
        int got = swr_convert(swr, &outp, out_n,
                              (const uint8_t **)f->extended_data,
                              f->nb_samples);
        if (got < 0) return got;
        pcm.resize(base + (size_t)got * channels);
        return 0;
    };

    bool eof = false;
    while (!eof) {
        ret = av_read_frame(fmt, pkt);
        if (ret == AVERROR_EOF) {
            eof = true;
            avcodec_send_packet(cc, nullptr);  // flush
        } else if (ret < 0) {
            return fail("read_frame", ret);
        } else {
            if (pkt->stream_index != stream_idx) {
                av_packet_unref(pkt);
                continue;
            }
            ret = avcodec_send_packet(cc, pkt);
            av_packet_unref(pkt);
            if (ret < 0 && ret != AVERROR(EAGAIN))
                return fail("send_packet", ret);
        }
        while (true) {
            ret = avcodec_receive_frame(cc, frame);
            if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) break;
            if (ret < 0) return fail("receive_frame", ret);
            if ((ret = push_frame(frame)) < 0)
                return fail("resample", ret);
            av_frame_unref(frame);
        }
    }

    if (channels == 0 || pcm.empty()) return fail("decoded zero samples", 0);

    int64_t frames = (int64_t)(pcm.size() / channels);
    float *out = (float *)malloc(pcm.size() * sizeof(float));
    if (!out) return fail("oom", 0);
    std::memcpy(out, pcm.data(), pcm.size() * sizeof(float));
    *out_pcm = out;
    *out_frames = frames;
    *out_channels = channels;
    *out_sr = sr;

    swr_free(&swr);
    avcodec_free_context(&cc);
    av_packet_free(&pkt);
    av_frame_free(&frame);
    avformat_close_input(&fmt);
    av_freep(&avio->buffer);
    avio_context_free(&avio);
    return 0;
}

int amw_lavc_encode(const float *pcm, int64_t frames, int channels, int sr,
                    const char *fmt_name, int bitrate_kbps, uint8_t **out,
                    int64_t *out_size, char *err, int errlen) {
    av_log_set_level(AV_LOG_ERROR);
    *out = nullptr;
    *out_size = 0;

    // container + encoder selection mirrors the CLI flags the ffmpeg
    // fallback uses (utils/audio_io.py): mp3 -> libmp3lame in mp3,
    // opus -> libopus in ogg, aac -> native aac in m4a (ipod).
    const char *mux, *enc_name;
    int enc_sr = sr;
    if (!std::strcmp(fmt_name, "mp3")) {
        mux = "mp3";
        enc_name = "libmp3lame";
    } else if (!std::strcmp(fmt_name, "opus")) {
        mux = "ogg";
        enc_name = "libopus";
        enc_sr = 48000;  // libopus fixed rates; 48 k matches the CLI path
    } else if (!std::strcmp(fmt_name, "aac") || !std::strcmp(fmt_name, "m4a")) {
        mux = "ipod";
        enc_name = "aac";
    } else {
        set_err(err, errlen, std::string("unsupported format: ") + fmt_name);
        return -1;
    }

    const AVCodec *enc = avcodec_find_encoder_by_name(enc_name);
    if (!enc) {
        set_err(err, errlen, std::string("encoder missing: ") + enc_name);
        return -1;
    }

    AVFormatContext *ofmt = nullptr;
    AVCodecContext *cc = nullptr;
    SwrContext *swr = nullptr;
    AVAudioFifo *fifo = nullptr;
    AVPacket *pkt = nullptr;
    AVFrame *frame = nullptr;
    AVIOContext *avio = nullptr;
    WriteBuf wb;
    int ret = 0;

    auto fail = [&](const std::string &m, int e) {
        set_err(err, errlen, m, e);
        if (swr) swr_free(&swr);
        if (fifo) av_audio_fifo_free(fifo);
        if (cc) avcodec_free_context(&cc);
        if (pkt) av_packet_free(&pkt);
        if (frame) av_frame_free(&frame);
        if (ofmt) avformat_free_context(ofmt);
        if (avio) {
            av_freep(&avio->buffer);
            avio_context_free(&avio);
        }
        return -1;
    };

    if ((ret = avformat_alloc_output_context2(&ofmt, nullptr, mux, nullptr)) <
        0)
        return fail("alloc_output_context", ret);

    cc = avcodec_alloc_context3(enc);
    av_channel_layout_default(&cc->ch_layout, channels);
    cc->sample_rate = enc_sr;
    // first supported sample format (lame/aac: fltp, opus: s16 then flt —
    // prefer flt when offered)
    AVSampleFormat want = AV_SAMPLE_FMT_NONE;
    if (enc->sample_fmts) {
        for (int i = 0; enc->sample_fmts[i] != AV_SAMPLE_FMT_NONE; i++)
            if (enc->sample_fmts[i] == AV_SAMPLE_FMT_FLT ||
                enc->sample_fmts[i] == AV_SAMPLE_FMT_FLTP) {
                want = enc->sample_fmts[i];
                break;
            }
        if (want == AV_SAMPLE_FMT_NONE) want = enc->sample_fmts[0];
    } else {
        want = AV_SAMPLE_FMT_FLTP;
    }
    cc->sample_fmt = want;
    if (bitrate_kbps > 0) cc->bit_rate = (int64_t)bitrate_kbps * 1000;
    cc->time_base = {1, enc_sr};
    if (ofmt->oformat->flags & AVFMT_GLOBALHEADER)
        cc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if ((ret = avcodec_open2(cc, enc, nullptr)) < 0)
        return fail("encoder open", ret);

    AVStream *st = avformat_new_stream(ofmt, nullptr);
    st->time_base = cc->time_base;
    if ((ret = avcodec_parameters_from_context(st->codecpar, cc)) < 0)
        return fail("parameters_from_context", ret);

    const int avio_buf_sz = 1 << 16;
    uint8_t *avio_buf = (uint8_t *)av_malloc(avio_buf_sz);
    avio = avio_alloc_context(avio_buf, avio_buf_sz, 1, &wb, nullptr,
                              write_cb, wseek_cb);
    ofmt->pb = avio;
    ofmt->flags |= AVFMT_FLAG_CUSTOM_IO;

    if ((ret = avformat_write_header(ofmt, nullptr)) < 0)
        return fail("write_header", ret);

    AVChannelLayout layout;
    av_channel_layout_default(&layout, channels);
    ret = swr_alloc_set_opts2(&swr, &layout, cc->sample_fmt, enc_sr, &layout,
                              AV_SAMPLE_FMT_FLT, sr, 0, nullptr);
    av_channel_layout_uninit(&layout);
    if (ret < 0 || (ret = swr_init(swr)) < 0) return fail("swr init", ret);

    fifo = av_audio_fifo_alloc(cc->sample_fmt, channels,
                               cc->frame_size > 0 ? cc->frame_size * 4 : 4096);
    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    const int fsz = cc->frame_size > 0 ? cc->frame_size : 1024;
    int64_t pts = 0;

    auto drain_packets = [&]() -> int {
        while (true) {
            int r = avcodec_receive_packet(cc, pkt);
            if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
            if (r < 0) return r;
            av_packet_rescale_ts(pkt, cc->time_base, st->time_base);
            pkt->stream_index = st->index;
            r = av_interleaved_write_frame(ofmt, pkt);
            if (r < 0) return r;
        }
    };

    auto encode_from_fifo = [&](bool flushing) -> int {
        while (av_audio_fifo_size(fifo) >= (flushing ? 1 : fsz)) {
            int take = av_audio_fifo_size(fifo);
            if (take > fsz) take = fsz;
            av_frame_unref(frame);
            frame->nb_samples = take;
            av_channel_layout_default(&frame->ch_layout, channels);
            frame->format = cc->sample_fmt;
            frame->sample_rate = enc_sr;
            int r = av_frame_get_buffer(frame, 0);
            if (r < 0) return r;
            if (av_audio_fifo_read(fifo, (void **)frame->extended_data,
                                   take) < take)
                return AVERROR_UNKNOWN;
            frame->pts = pts;
            pts += take;
            r = avcodec_send_frame(cc, frame);
            if (r < 0) return r;
            if ((r = drain_packets()) < 0) return r;
        }
        return 0;
    };

    // feed input in ~1 s slices: swr-convert, fifo, encode
    const int64_t slice = sr;
    // scratch for converted samples (planar or interleaved per enc fmt)
    AVFrame *conv = av_frame_alloc();
    for (int64_t off = 0; off < frames; off += slice) {
        int in_n = (int)((frames - off) < slice ? (frames - off) : slice);
        int max_out = (int)av_rescale_rnd(swr_get_delay(swr, sr) + in_n,
                                          enc_sr, sr, AV_ROUND_UP) + 32;
        av_frame_unref(conv);
        conv->nb_samples = max_out;
        av_channel_layout_default(&conv->ch_layout, channels);
        conv->format = cc->sample_fmt;
        conv->sample_rate = enc_sr;
        if ((ret = av_frame_get_buffer(conv, 0)) < 0) {
            av_frame_free(&conv);
            return fail("conv buffer", ret);
        }
        const uint8_t *inp = (const uint8_t *)(pcm + off * channels);
        int got = swr_convert(swr, conv->extended_data, max_out, &inp, in_n);
        if (got < 0) {
            av_frame_free(&conv);
            return fail("swr_convert", got);
        }
        if (got > 0 &&
            av_audio_fifo_write(fifo, (void **)conv->extended_data, got) <
                got) {
            av_frame_free(&conv);
            return fail("fifo write", 0);
        }
        if ((ret = encode_from_fifo(false)) < 0) {
            av_frame_free(&conv);
            return fail("encode", ret);
        }
    }
    // flush resampler
    {
        av_frame_unref(conv);
        conv->nb_samples = (int)av_rescale_rnd(swr_get_delay(swr, sr) + 64,
                                               enc_sr, sr, AV_ROUND_UP) + 64;
        av_channel_layout_default(&conv->ch_layout, channels);
        conv->format = cc->sample_fmt;
        conv->sample_rate = enc_sr;
        if ((ret = av_frame_get_buffer(conv, 0)) < 0) {
            av_frame_free(&conv);
            return fail("conv buffer", ret);
        }
        int got = swr_convert(swr, conv->extended_data, conv->nb_samples,
                              nullptr, 0);
        if (got > 0)
            av_audio_fifo_write(fifo, (void **)conv->extended_data, got);
    }
    av_frame_free(&conv);
    if ((ret = encode_from_fifo(true)) < 0) return fail("encode tail", ret);
    if ((ret = avcodec_send_frame(cc, nullptr)) < 0 && ret != AVERROR_EOF)
        return fail("encoder flush", ret);
    if ((ret = drain_packets()) < 0) return fail("drain", ret);
    if ((ret = av_write_trailer(ofmt)) < 0) return fail("trailer", ret);
    avio_flush(avio);

    uint8_t *blob = (uint8_t *)malloc(wb.data.size() ? wb.data.size() : 1);
    if (!blob) return fail("oom", 0);
    std::memcpy(blob, wb.data.data(), wb.data.size());
    *out = blob;
    *out_size = (int64_t)wb.data.size();

    swr_free(&swr);
    av_audio_fifo_free(fifo);
    avcodec_free_context(&cc);
    av_packet_free(&pkt);
    av_frame_free(&frame);
    avformat_free_context(ofmt);
    av_freep(&avio->buffer);
    avio_context_free(&avio);
    return 0;
}

}  // extern "C"
